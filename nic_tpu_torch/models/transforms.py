"""The four convolutional transforms of the mean-scale hyperprior
(counterpart of nic_tpu/models/transforms.py).

g_a downsamples 16x, h_a another 4x; g_s and h_s undo it. Submodule names
follow nic_tpu's parameter paths (``layer_i``, ``gdn_i``, ``igdn_i``).
Each transform computes in its ``dtype`` and returns float32.
"""

from typing import Optional

import torch
from torch import nn

from nic_tpu_torch.models.layers import GDN, SignalConv


class AnalysisTransform(nn.Module):
    """Image -> latent encoder g_a (4x 5x5/down2, GDN after the first three)."""

    def __init__(self, num_filters: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        n = num_filters
        for i in range(3):
            setattr(self, f"layer_{i}", SignalConv(3 if i == 0 else n, n, 5,
                                                   strides_down=2, dtype=dtype))
            setattr(self, f"gdn_{i}", GDN(n, dtype=dtype))
        self.layer_3 = SignalConv(n, n, 5, strides_down=2, dtype=dtype)

    def forward(self, x):
        for i in range(3):
            x = getattr(self, f"gdn_{i}")(getattr(self, f"layer_{i}")(x))
        return self.layer_3(x).float()


class SynthesisTransform(nn.Module):
    """Latent -> image decoder g_s (4x 5x5/up2, IGDN after the first three).

    ``quant`` (None, "int8", "int8_all") applies to the three N -> N
    up-convs only; the 192 -> 3 output layer stays in ``dtype``.
    ``upsample_impl`` applies to all four (``SignalConv``)."""

    def __init__(self, num_filters: int, dtype: torch.dtype = torch.float32,
                 upsample_impl: str = "transpose", quant: Optional[str] = None):
        super().__init__()
        n = num_filters
        for i in range(3):
            setattr(self, f"layer_{i}", SignalConv(n, n, 5, strides_up=2, dtype=dtype,
                                                   upsample_impl=upsample_impl,
                                                   quant=quant))
            setattr(self, f"igdn_{i}", GDN(n, inverse=True, dtype=dtype))
        self.layer_3 = SignalConv(n, 3, 5, strides_up=2, dtype=dtype,
                                  upsample_impl=upsample_impl)

    def forward(self, y, block_space: bool = False):
        """``block_space``: the last layer's output in 2x2-block space
        (N, H/2, W/2, 12), the image modulo depth-to-space."""
        for i in range(3):
            y = getattr(self, f"igdn_{i}")(getattr(self, f"layer_{i}")(y))
        return self.layer_3(y, block_space_output=block_space).float()


class HyperAnalysisTransform(nn.Module):
    """y -> z hyper-encoder h_a (3x3/s1, 5x5/down2, 5x5/down2 bias-free; relu)."""

    def __init__(self, num_filters: int, num_output_filters: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        n = num_filters
        out = num_output_filters or n
        self.layer_0 = SignalConv(n, n, 3, strides_down=1, dtype=dtype)
        self.layer_1 = SignalConv(n, n, 5, strides_down=2, dtype=dtype)
        self.layer_2 = SignalConv(n, out, 5, strides_down=2, use_bias=False, dtype=dtype)

    def forward(self, y):
        y = torch.relu(self.layer_0(y))
        y = torch.relu(self.layer_1(y))
        return self.layer_2(y).float()


class HyperSynthesisTransform(nn.Module):
    """The symmetric z -> (mu, log sigma) decoder (2x 5x5/up2 with relu, then
    a 3x3 conv to ``num_output_filters``). No model uses it: MBT2018 and its
    bits-back variant take ``MBT2018HyperSynthesisTransform``. It is nic_tpu's
    public ``HyperSynthesisTransform``, kept with its parameter names."""

    def __init__(self, num_filters: int, num_output_filters: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        n = num_filters
        out = num_output_filters or n
        self.layer_0 = SignalConv(n, n, 5, strides_up=2, dtype=dtype)
        self.layer_1 = SignalConv(n, n, 5, strides_up=2, dtype=dtype)
        self.layer_2 = SignalConv(n, out, 3, dtype=dtype)

    def forward(self, z):
        z = torch.relu(self.layer_0(z))
        z = torch.relu(self.layer_1(z))
        return self.layer_2(z).float()


class MBT2018HyperSynthesisTransform(nn.Module):
    """z -> (mu, log sigma) decoder h_s; the middle layer widens to 1.5N.

    ``quant`` applies to the two up-convs; the 3x3 output layer stays in
    ``dtype``."""

    def __init__(self, num_filters: int, num_output_filters: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, upsample_impl: str = "transpose",
                 quant: Optional[str] = None):
        super().__init__()
        n = num_filters
        mid = int(n * 1.5)
        out = num_output_filters or n
        self.layer_0 = SignalConv(n, n, 5, strides_up=2, dtype=dtype,
                                  upsample_impl=upsample_impl, quant=quant)
        self.layer_1 = SignalConv(n, mid, 5, strides_up=2, dtype=dtype,
                                  upsample_impl=upsample_impl, quant=quant)
        self.layer_2 = SignalConv(mid, out, 3, strides_down=1, dtype=dtype)

    def forward(self, z):
        z = torch.relu(self.layer_0(z))
        z = torch.relu(self.layer_1(z))
        return self.layer_2(z).float()
