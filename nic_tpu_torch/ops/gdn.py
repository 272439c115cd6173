"""Generalized divisive normalization (counterpart of nic_tpu/ops/gdn.py).

``gdn`` dispatches on where the activation lies: a CUDA tensor goes through
the hand-written kernel (``ops/gdn_cuda.py``), which launches or raises; a
CPU tensor takes the plain version ``gdn_reference``, which sits beside the
kernel's wrapper. There is no fallback between the two.
"""

from nic_tpu_torch.ops.gdn_cuda import gdn_kernel, gdn_reference

__all__ = ["gdn", "gdn_reference"]


def gdn(x, beta, gamma, inverse: bool = False):
    """Apply (inverse) GDN over the channel-last axis.

    y_j = x_j / sqrt(beta_j + sum_i gamma[i, j] * x_i^2)   (inverse: multiply)

    Args:
      x: [..., C] activations, float32 or bfloat16.
      beta: [C] nonnegative offsets.
      gamma: [C, C] nonnegative mixing weights.
      inverse: if True computes IGDN (synthesis direction).
    """
    if x.device.type == "cuda":
        return gdn_kernel(x, beta, gamma, inverse)
    if x.device.type == "cpu":
        return gdn_reference(x, beta, gamma, inverse)
    raise ValueError(f"GDN runs on cuda or cpu tensors, not {x.device}")
