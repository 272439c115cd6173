"""Host-side utilities: image I/O and run naming (counterpart of nic_tpu/utils.py)."""

from typing import Dict, Sequence

import numpy as np


def read_image(path: str) -> np.ndarray:
    """Load an image file as float32 HxWx3 in [0, 1]."""
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB"), dtype=np.float32)
    return img / 255.0


def load_input(path: str) -> np.ndarray:
    """Load a single image or an [N,H,W,3] .npy batch, scaled to [0, 1]."""
    if path.endswith(".npy"):
        x = np.load(path).astype(np.float32)
        if x.max() > 1.5:  # stored as 0..255
            x = x / 255.0
        return x
    return read_image(path)[None, ...]


def pad_to_64(x: np.ndarray) -> np.ndarray:
    """An [N, H, W, C] batch edge-padded at the bottom and right to multiples
    of 64, the model's total stride."""
    ph, pw = (-x.shape[1]) % 64, (-x.shape[2]) % 64
    return np.pad(x, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="edge")


def quantize_image(img: np.ndarray) -> np.ndarray:
    """float [0,1] -> uint8 with saturation."""
    return np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """Save a float [0,1] HxWx3 image as PNG."""
    from PIL import Image

    Image.fromarray(quantize_image(img)).save(path, format="PNG")


def convert_float_to_uint8(img: np.ndarray) -> np.ndarray:
    """float [0,1] -> uint8 pixels with saturation."""
    return quantize_image(img)


def convert_uint8_to_float(img: np.ndarray) -> np.ndarray:
    """uint8 pixels -> float [0,1]."""
    return img.astype(np.float32) / 255.0


def get_runname(
    args_dict: Dict,
    record_keys: Sequence[str] = ("num_filters", "num_hfilters", "lmbda", "last_step"),
    prefix: str = "",
) -> str:
    """Run-identifying string, e.g. 'mbt2018-num_filters=192-lmbda=0.01'.
    Skips num_hfilters when <= 0."""
    config_strs = []
    for key in record_keys:
        if key == "num_hfilters" and int(args_dict.get(key, -1)) <= 0:
            continue
        config_strs.append(f"{key}={args_dict[key]}")
    return "-".join([prefix] + config_strs)


def parse_lmbda_from_runname(runname: str) -> float:
    """Recover the training lambda from a runname."""
    return float(runname.split("lmbda=")[1].split("-")[0])
