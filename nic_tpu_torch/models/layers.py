"""Strided signal convolutions and GDN (counterpart of nic_tpu/models/layers.py).

Activations are NHWC at every public function, as in nic_tpu. Each layer
computes in its ``dtype`` (float32, or bfloat16 for the bf16 transforms):
it casts its input and its weights down, while the parameters stay float32.
A convolution permutes its input to an NCHW view with channels-last
strides, which cuDNN takes as it is, and permutes the result back.

Padding reproduces XLA's "SAME":
- down (stride s, k x k): pad p = max((ceil(H/s) - 1) * s + k - H, 0), top
  p // 2 and bottom p - p // 2 (likewise for W), then a VALID strided conv;
- up (5x5, stride 2; ``lax.conv_transpose`` with an un-flipped HWIO kernel):
  ``conv_transpose2d`` of the flipped kernel with padding 1, cropped to
  (2H, 2W).
"""

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nic_tpu_torch.ops.bounds import lower_bound
from nic_tpu_torch.ops.gdn import gdn as gdn_op


def _same_pads(size: int, kernel: int, stride: int):
    out = -(-size // stride)
    p = max((out - 1) * stride + kernel - size, 0)
    return p // 2, p - p // 2


def conv_transpose_up2(x, weight, bias=None):
    """XLA's SAME 5x5 stride-2 transposed conv, NHWC in and out: ``weight``
    is (in, out, 5, 5), spatially flipped (``SignalConv.weight_from_hwio``)."""
    h, w = x.shape[1], x.shape[2]
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), weight, bias, stride=2, padding=1)
    return y.permute(0, 2, 3, 1)[:, : 2 * h, : 2 * w, :]


class SignalConv(nn.Module):
    """2-D convolution with integer down- or up-sampling (NHWC in and out).

    ``strides_down=s`` -> strided conv, output ceil(H/s);
    ``strides_up=2``   -> 5x5 transposed conv, output 2H.

    ``weight`` is stored as the torch op takes it: (out, in, kh, kw) for a
    down or stride-1 conv; (in, out, kh, kw), spatially flipped, for an up
    conv. ``weight_from_hwio`` converts an nic_tpu HWIO kernel.

    ``dtype`` is the computation dtype: the input and the weight are cast to
    it before the conv, and in bfloat16 the bias is added after the conv in
    bfloat16, as nic_tpu adds it; the output is in ``dtype``.
    """

    def __init__(self, in_channels: int, features: int, kernel: int = 5,
                 strides_down: int = 1, strides_up: int = 1,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        if strides_down > 1 and strides_up > 1:
            raise ValueError("Cannot both down- and up-sample.")
        if strides_up > 1 and (strides_up, kernel) != (2, 5):
            raise NotImplementedError("up-sampling is ported for 5x5 stride 2 only")
        self.kernel = kernel
        self.strides_down = strides_down
        self.strides_up = strides_up
        self.transpose = strides_up > 1
        shape = ((in_channels, features) if self.transpose
                 else (features, in_channels)) + (kernel, kernel)
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """nic_tpu's initial values: the kernel from variance_scaling(1.0,
        "fan_avg", "uniform"), drawn from ``generator``; a zero bias."""
        channels_in_and_out = self.weight.shape[0] + self.weight.shape[1]
        fan_avg = self.kernel * self.kernel * channels_in_and_out / 2.0
        limit = math.sqrt(3.0 / fan_avg)
        nn.init.uniform_(self.weight, -limit, limit, generator=generator)
        if self.bias is not None:
            self.bias.zero_()

    def weight_from_hwio(self, kernel_hwio: np.ndarray) -> torch.Tensor:
        """This layer's ``weight`` from an nic_tpu (kh, kw, in, out) kernel."""
        k = np.asarray(kernel_hwio, np.float32)
        if self.transpose:
            k = k[::-1, ::-1].transpose(2, 3, 0, 1)
        else:
            k = k.transpose(3, 2, 0, 1)
        return torch.from_numpy(np.ascontiguousarray(k))

    def weight_to_hwio(self, weight: torch.Tensor) -> np.ndarray:
        """The nic_tpu (kh, kw, in, out) kernel of this layer's ``weight``:
        the inverse of ``weight_from_hwio``; a copy."""
        w = weight.detach().cpu().float().numpy()
        if self.transpose:
            return np.ascontiguousarray(w.transpose(2, 3, 0, 1)[::-1, ::-1])
        return np.ascontiguousarray(w.transpose(2, 3, 1, 0))

    def forward(self, x):
        n, h, w, _ = x.shape
        x = x.to(self.dtype)
        weight = self.weight.to(self.dtype)
        # In float32 cuDNN adds the bias inside the conv; a bfloat16 conv
        # rounds its sum first, and the bias is added to the rounded value.
        fused = self.bias if self.dtype == torch.float32 else None
        if self.transpose:
            y = conv_transpose_up2(x, weight, fused)
        else:
            s, k = self.strides_down, self.kernel
            top, bottom = _same_pads(h, k, s)
            left, right = _same_pads(w, k, s)
            x = F.pad(x, (0, 0, left, right, top, bottom))
            y = F.conv2d(x.permute(0, 3, 1, 2), weight, fused, stride=s).permute(0, 2, 3, 1)
        if self.bias is not None and fused is None:
            y = y + self.bias.to(self.dtype)
        return y


class GDN(nn.Module):
    """Generalized divisive normalization layer.

    Parameters use the square-root "nonnegative" reparameterization with a
    small pedestal: the stored variable v maps to ``lower_bound(v, b)^2 - p``
    with pedestal p = offset^2 and bound b = sqrt(minimum + p). The stored
    values are nic_tpu's. Initial effective values: beta = 1, gamma = 0.1 * I.

    ``dtype`` is the computation dtype: x is cast to it, and ``ops/gdn.gdn``
    casts gamma to x's dtype and keeps beta and the normalizer in float32.
    """

    def __init__(self, channels: int, inverse: bool = False,
                 beta_min: float = 1e-6, reparam_offset: float = 2 ** -18,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.inverse = inverse
        self.pedestal = reparam_offset ** 2
        self.beta_bound = (beta_min + self.pedestal) ** 0.5
        self.gamma_bound = reparam_offset
        self.beta = nn.Parameter(
            torch.full((channels,), (1.0 + self.pedestal) ** 0.5)
        )
        self.gamma = nn.Parameter(
            torch.sqrt(0.1 * torch.eye(channels) + self.pedestal)
        )
        # Data-parallel training sets it (Comm.average_grad): the effective
        # parameters' gradient is then the global batch's before the bounds'
        # gate reads its sign.
        self.average_grad: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def effective_params(self):
        """(beta, gamma) as the normalization uses them."""
        beta = torch.square(lower_bound(self.beta, self.beta_bound)) - self.pedestal
        gamma = torch.square(lower_bound(self.gamma, self.gamma_bound)) - self.pedestal
        if self.average_grad is not None:
            beta, gamma = self.average_grad(beta), self.average_grad(gamma)
        return beta, gamma

    def forward(self, x):
        beta, gamma = self.effective_params()
        return gdn_op(x.to(self.dtype), beta, gamma, inverse=self.inverse)
