"""Checkpoints of the port (counterpart of nic_tpu/train/checkpoint.py).

Two formats under ``<checkpoint_dir>/<runname>/``:
- ``params-<step>.npz``, nic_tpu's parameter archive: the model's
  parameters as flat '/'-joined keys (``analysis/layer_0/kernel``,
  ``synthesis/igdn_2/gamma``, ...), float32, with HWIO conv kernels. It
  moves both ways between nic_tpu and the port. Two models read it: MBT2018
  (factorized prior under ``entropy_bottleneck/``) and its bits-back variant
  (``hyper_prior/``, with h_a and h_s emitting 2N channels).
- ``ckpt-<step>.pt``, the port's full training state (``torch.save``): the
  model's state_dict, the Adam state of both groups, the step and the noise
  generator's state. nic_tpu's orbax trees are not ported.
"""

import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from nic_tpu_torch.models.layers import SignalConv
from nic_tpu_torch.models.mbt2018 import MeanScaleHyperprior
from nic_tpu_torch.models.mbt2018_bb import BitsBackHyperprior

_NPZ_RE = re.compile(r"params-(\d+)\.npz")
_CKPT_RE = re.compile(r"ckpt-(\d+)\.pt")
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


def npz_step(path: str) -> int:
    m = _NPZ_RE.fullmatch(os.path.basename(path))
    return int(m.group(1)) if m else 0


def load_params_npz(path: str) -> Tuple[int, Dict[str, np.ndarray]]:
    """(step, flat '/'-keyed params) from a params-<step>.npz archive."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return npz_step(path), flat


def export_params_npz(save_dir: str, step: int, flat: Dict[str, np.ndarray]) -> str:
    """Write nic_tpu's flat parameters as <save_dir>/params-<step>.npz
    (compressed, float32), through a temporary file and an atomic rename."""
    arrays = {k: np.asarray(v, dtype=np.float32) for k, v in flat.items()}
    path = os.path.join(save_dir, f"params-{step}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, path)
    return path


def latest_step(save_dir: str) -> Optional[int]:
    """The highest step of a full training state ckpt-<step>.pt, or None."""
    if not os.path.isdir(save_dir):
        return None
    steps = [int(m.group(1)) for m in map(_CKPT_RE.fullmatch, os.listdir(save_dir)) if m]
    return max(steps) if steps else None


def save_checkpoint(save_dir: str, step: int, state: Dict[str, Any]) -> str:
    """Write a full training state as <save_dir>/ckpt-<step>.pt, through a
    temporary file and an atomic rename."""
    path = os.path.join(save_dir, f"ckpt-{step}.pt")
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def restore_checkpoint(save_dir: str, step: Optional[int] = None) -> Dict[str, Any]:
    """The full training state of ``step`` (the latest by default), its
    tensors on the CPU."""
    if step is None:
        step = latest_step(save_dir)
    if step is None:
        raise FileNotFoundError(f"No checkpoints under {save_dir}")
    return torch.load(os.path.join(save_dir, f"ckpt-{step}.pt"), map_location="cpu",
                      weights_only=True)


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
    return module_params_from_jax(template, flat)


def module_params_from_jax(template: torch.nn.Module,
                           flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A state_dict of ``template`` (any module of the port whose submodule
    names are nic_tpu's, e.g. a transform) from nic_tpu's flat parameters of
    the same module; ``template`` may live on the meta device. Raises on a
    missing, extra or mis-shaped key."""
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


def params_to_jax(state: Dict[str, torch.Tensor],
                  model: str = "mbt2018") -> Dict[str, np.ndarray]:
    """nic_tpu's flat '/'-keyed float32 parameters from a state_dict of
    ``model``: the inverse of ``params_from_jax`` (conv weights back to HWIO
    kernels under ``kernel``). The arrays are copies."""
    num_filters = int(state["analysis.layer_0.weight"].shape[0])
    with torch.device("meta"):
        template = MODELS[model][0](num_filters)
    flat = {}
    for name, value in state.items():
        *path, leaf = name.split(".")
        module = template.get_submodule(".".join(path))
        if isinstance(module, SignalConv) and leaf == "weight":
            leaf, array = "kernel", module.weight_to_hwio(value)
        else:
            array = value.detach().cpu().float().numpy().copy()
        flat["/".join(path + [leaf])] = array
    return flat


def latest_params(save_dir: str, model: str = "mbt2018"):
    """(step, state_dict, path) of a run's newest parameters.

    A params-<step>.npz at exactly the newest full state's step wins (a
    repair may rewrite only the npz); the full state wins otherwise. An npz
    ahead of every full state is a stale leftover of an earlier run in the
    same directory, and is ignored with a message."""
    full = latest_step(save_dir)
    npz = latest_npz(save_dir)
    if npz is not None and (full is None or npz_step(npz) == full):
        step, flat = load_params_npz(npz)
        return step, params_from_jax(flat, model), npz
    if npz is not None and npz_step(npz) > full:
        print(f"latest_params: ignoring {npz} (step {npz_step(npz)} ahead of the "
              f"latest full state, step {full}: a stale leftover of an earlier run?)")
    if full is None:
        raise FileNotFoundError(f"no params-<step>.npz or ckpt-<step>.pt under {save_dir}")
    state = restore_checkpoint(save_dir, full)
    if state["model_name"] != model:
        raise KeyError(f"{save_dir}: a {state['model_name']} checkpoint, not {model}")
    return full, state["model"], os.path.join(save_dir, f"ckpt-{full}.pt")


def load_model(checkpoint_dir: str, runname: str, num_filters: int, device,
               compute_dtype: torch.dtype = torch.float32,
               model: str = "mbt2018") -> Tuple[int, torch.nn.Module]:
    """(step, model) from the newest parameters of a run (``latest_params``),
    on ``device``, in eval mode with its parameters frozen; its transforms
    compute in ``compute_dtype`` (the parameters stay float32). ``model``
    names the architecture ("mbt2018" or "mbt2018_bb"), checked against the
    checkpoint."""
    step, state, path = latest_params(os.path.join(checkpoint_dir, runname), model)
    filters = state["analysis.layer_0.weight"].shape[0]
    if filters != num_filters:
        raise ValueError(f"{path} holds num_filters={filters}, not {num_filters}")
    net = MODELS[model][0](num_filters, compute_dtype)
    net.load_state_dict(state)
    net.to(device).eval().requires_grad_(False)
    print(f"load_model: {path} (step {step})")
    return step, net
