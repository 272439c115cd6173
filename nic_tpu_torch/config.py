"""Global constants and device policy (counterpart of nic_tpu/config.py).

The constants are copies of nic_tpu's, kept here so the port never imports
the JAX package.

Precision: fp32 means fp32. cuDNN runs float32 convolutions in TF32 by
default, which keeps about three decimal digits; the JAX CLI path computes
in full fp32. `set_fp32_precision` turns TF32 off for both cuDNN
convolutions and cuBLAS matmuls, and every entry point of the port calls it.
"""

import numpy as np
import torch

# Conditional Gaussian scale table.
SCALES_MIN = 0.11
SCALES_MAX = 256.0
SCALES_LEVELS = 64


def scale_table() -> np.ndarray:
    """Log-spaced scale table used by the conditional entropy model."""
    return np.exp(
        np.linspace(np.log(SCALES_MIN), np.log(SCALES_MAX), SCALES_LEVELS)
    ).astype(np.float32)


# Likelihood lower bound.
LIKELIHOOD_LOWER_BOUND = 1e-9

# sigma^2 upper bound of the bits-back model while it trains.
VARIANCE_UPPER_BOUND_BB_TRAIN = 1e1

# atanh clipping epsilon in the SGA relaxation.
ATANH_EPSILON = 1e-5

DEFAULT_SEED = 0

# Eval batching by pixel budget.
EVAL_BATCH_NUM_PIXELS = 1e7

CHECKPOINT_DIR = "./checkpoints"

# Entropy-coding table parameters.
CODER_PRECISION = 16      # bits of CDF precision for the rANS coder
CONDITIONAL_TAIL_MASS = 2 ** -8
FACTORIZED_TAIL_MASS = 1e-9

# Whether `mbt2018 compress` writes a bitstream when no output file is named.
WRITE_BITSTREAM_FOR_EVAL = False


def get_eval_batch_size(num_pixels_per_image: int) -> int:
    """Auto batch size from a fixed pixel budget."""
    return max(1, round(EVAL_BATCH_NUM_PIXELS / num_pixels_per_image))


def set_fp32_precision() -> None:
    """Full fp32 for convolutions and matmuls: no TF32 anywhere.

    Process-wide torch flags; every entry point sets them before it runs.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. Raises when the card is asked for and there is none; the
    port never falls back to the CPU on its own."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device
