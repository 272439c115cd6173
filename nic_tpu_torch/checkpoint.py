"""Parameters from nic_tpu's committed npz archives
(counterpart of the npz half of nic_tpu/train/checkpoint.py).

A ``params-<step>.npz`` holds the model's parameters as flat '/'-joined
keys (``analysis/layer_0/kernel``, ``synthesis/igdn_2/gamma``, ...), float32,
with HWIO conv kernels. It is the only checkpoint format the port reads;
orbax trees are not ported. Two models read it: MBT2018 (factorized prior
under ``entropy_bottleneck/``) and its bits-back variant (``hyper_prior/``,
with h_a and h_s emitting 2N channels).
"""

import os
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nic_tpu_torch.models.layers import SignalConv
from nic_tpu_torch.models.mbt2018 import MeanScaleHyperprior
from nic_tpu_torch.models.mbt2018_bb import BitsBackHyperprior

_NPZ_RE = re.compile(r"params-(\d+)\.npz")
# Each model, and the prefix of its z prior's keys.
MODELS = {"mbt2018": (MeanScaleHyperprior, "entropy_bottleneck/"),
          "mbt2018_bb": (BitsBackHyperprior, "hyper_prior/")}


def latest_npz(save_dir: str) -> Optional[str]:
    """Path of the highest-step params-<step>.npz under save_dir, or None."""
    if not os.path.isdir(save_dir):
        return None
    best, best_step = None, -1
    for name in os.listdir(save_dir):
        m = _NPZ_RE.fullmatch(name)
        if m and int(m.group(1)) > best_step:
            best_step, best = int(m.group(1)), os.path.join(save_dir, name)
    return best


def load_params_npz(path: str) -> Tuple[int, Dict[str, np.ndarray]]:
    """(step, flat '/'-keyed params) from a params-<step>.npz archive."""
    m = _NPZ_RE.fullmatch(os.path.basename(path))
    step = int(m.group(1)) if m else 0
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return step, flat


def params_from_jax(flat: Dict[str, np.ndarray],
                    model: str = "mbt2018") -> Dict[str, torch.Tensor]:
    """A state_dict of ``model`` ("mbt2018": MeanScaleHyperprior,
    "mbt2018_bb": BitsBackHyperprior) from nic_tpu's flat parameters.

    HWIO conv kernels become what ``conv2d`` (out, in, kh, kw) and
    ``conv_transpose2d`` (in, out, kh, kw, flipped) take; every other array
    keeps its shape. Raises when the keys belong to the other model, and on
    a missing, extra or mis-shaped key.
    """
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r}; expected one of {sorted(MODELS)}")
    if "analysis/layer_0/kernel" not in flat:
        raise KeyError(f"not a {model} parameter set: no analysis/layer_0/kernel")
    for name, (_, prefix) in MODELS.items():
        if name != model and any(k.startswith(prefix) for k in flat):
            raise KeyError(f"the parameters hold {prefix}* keys: a {name} parameter "
                           f"set, not {model}")
    num_filters = int(flat["analysis/layer_0/kernel"].shape[-1])
    with torch.device("meta"):
        template = MODELS[model][0](num_filters)
    expected = template.state_dict()
    state, extra = {}, []
    for key, value in flat.items():
        *path, leaf = key.split("/")
        try:
            module = template.get_submodule(".".join(path))
        except AttributeError:
            extra.append(key)
            continue
        if isinstance(module, SignalConv) and leaf == "kernel":
            leaf, tensor = "weight", module.weight_from_hwio(value)
        else:
            tensor = torch.from_numpy(np.array(value, np.float32))
        name = ".".join(path + [leaf])
        if name not in expected:
            extra.append(key)
            continue
        if tuple(tensor.shape) != tuple(expected[name].shape):
            raise ValueError(
                f"{key}: shape {tuple(value.shape)} does not fit {name} "
                f"{tuple(expected[name].shape)}"
            )
        state[name] = tensor
    missing = sorted(set(expected) - set(state))
    if missing or extra:
        raise KeyError(f"parameter mismatch: missing {missing}, extra {sorted(extra)}")
    return state


def load_model(checkpoint_dir: str, runname: str, num_filters: int, device,
               compute_dtype: torch.dtype = torch.float32,
               model: str = "mbt2018") -> Tuple[int, torch.nn.Module]:
    """(step, model) from the newest params-<step>.npz of a run, on
    ``device``, in eval mode with its parameters frozen; its transforms
    compute in ``compute_dtype`` (the parameters stay float32). ``model``
    names the architecture ("mbt2018" or "mbt2018_bb"), checked against the
    archive's keys."""
    save_dir = os.path.join(checkpoint_dir, runname)
    path = latest_npz(save_dir)
    if path is None:
        raise FileNotFoundError(f"no params-<step>.npz under {save_dir}")
    step, flat = load_params_npz(path)
    state = params_from_jax(flat, model)
    filters = state["analysis.layer_0.weight"].shape[0]
    if filters != num_filters:
        raise ValueError(f"{path} holds num_filters={filters}, not {num_filters}")
    net = MODELS[model][0](num_filters, compute_dtype)
    net.load_state_dict(state)
    net.to(device).eval().requires_grad_(False)
    print(f"load_model: {path} (step {step})")
    return step, net
