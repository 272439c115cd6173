"""Strided signal convolutions and GDN (counterpart of nic_tpu/models/layers.py).

Activations are NHWC at every public function, as in nic_tpu. Each layer
computes in its ``dtype`` (float32, or bfloat16 for the bf16 transforms):
it casts its input and its weights down, while the parameters stay float32.
A convolution permutes its input to an NCHW view with channels-last
strides, which cuDNN takes as it is, and permutes the result back.

Padding reproduces XLA's "SAME":
- down (stride s, k x k): pad p = max((ceil(H/s) - 1) * s + k - H, 0), top
  p // 2 and bottom p - p // 2 (likewise for W), then a VALID strided conv;
- up (stride s, k x k; ``lax.conv_transpose`` with an un-flipped HWIO
  kernel): ``conv_transpose2d`` of the flipped kernel, its padding and
  output padding from XLA's (``conv_transpose_pads``), cropped to (sH, sW).

The 5x5 stride-2 up-conv has two other forms, element-exact with it up to
float rounding: "phases", four dense convs, one per output parity (25 live
taps), and "subpixel", one dense 3x3 conv with 4 x Co outputs and a
depth-to-space (36 taps). The four-parity split (``phase_taps``) is also
the structure of K2 (ops/convt_igdn.py) and of the int8 up-conv
(ops/int8conv.py).
"""

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nic_tpu_torch.ops.bounds import lower_bound
from nic_tpu_torch.ops.gdn import gdn as gdn_op

UPSAMPLE_IMPLS = ("transpose", "phases", "subpixel")
QUANT_MODES = (None, "int8", "int8_all")


def same_pads(size: int, kernel: int, stride: int):
    """XLA's SAME padding (before, after) of a strided conv."""
    out = -(-size // stride)
    p = max((out - 1) * stride + kernel - size, 0)
    return p // 2, p - p // 2


def conv_transpose_pads(kernel: int, stride: int):
    """``conv_transpose2d``'s (padding, output_padding) for XLA's SAME
    transposed conv: XLA pads the dilated input by pad_a before, which is
    padding k - 1 - pad_a; the output padding makes the output at least
    stride * H long (it is then cropped to that)."""
    pad_len = kernel + stride - 2
    pad_a = kernel - 1 if stride > kernel - 1 else -(-pad_len // 2)
    return kernel - 1 - pad_a, max(0, stride - (2 * pad_a - kernel + 2))


def conv_transpose_same(x, weight, stride: int = 2, bias=None):
    """XLA's SAME transposed conv, NHWC in and out, output (sH, sW):
    ``weight`` is (in, out, k, k), spatially flipped
    (``SignalConv.weight_from_hwio``)."""
    h, w = x.shape[1], x.shape[2]
    pad, out_pad = conv_transpose_pads(weight.shape[-1], stride)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), weight, bias, stride=stride,
                           padding=pad, output_padding=out_pad)
    return y.permute(0, 2, 3, 1)[:, : stride * h, : stride * w, :]


def conv_transpose_up2(x, weight, bias=None):
    """XLA's SAME 5x5 stride-2 transposed conv (``conv_transpose_same``)."""
    return conv_transpose_same(x, weight, 2, bias)


def phase_taps(r: int, t: int):
    """Tap offsets (a, b) of output parity (r, t) of the 5x5 stride-2
    transposed conv, weight wf[2a+r+1, 2b+t+1] (wf = w[::-1, ::-1]), a and
    b in descending order: out[2i+r, 2j+t] = sum x[i-a, j-b] @ wf[...].
    XLA's SAME transposed conv places the flipped kernel at 2q - 1, so only
    the taps with 0 <= 2a+r+1 < 5 are live: 4/6/6/9 for the parities
    (0,0)/(0,1)/(1,0)/(1,1)."""
    a_taps = [a for a in (1, 0, -1) if 0 <= 2 * a + r + 1 < 5]
    b_taps = [b for b in (1, 0, -1) if 0 <= 2 * b + t + 1 < 5]
    return a_taps, b_taps


def phase_kernels_up2(w):
    """The four parity kernels of a (5, 5, C, Co) transposed-conv kernel:
    [(r, t, kernel (ka, kb, C, Co), (pad_top, pad_left))], each a dense
    VALID conv of x padded (pad_top, ka - 1 - pad_top) rows and likewise
    columns (nic_tpu's ``_phase_kernels_up2``)."""
    if tuple(w.shape[:2]) != (5, 5):
        raise NotImplementedError("phase rewrite is specialized to 5x5 kernels")
    wf = w.flip(0, 1)
    out = []
    for r in range(2):
        for t in range(2):
            a_taps, b_taps = phase_taps(r, t)
            k = torch.stack([
                torch.stack([wf[2 * a + r + 1, 2 * b + t + 1] for b in b_taps])
                for a in a_taps
            ])
            out.append((r, t, k, (max(a_taps), max(b_taps))))
    return out


def phase_weight_mats(w):
    """Per-parity im2col weight matrices [taps*C, Co] of a (5, 5, C, Co)
    kernel, taps a-major then b, parities in the order (0,0), (0,1), (1,0),
    (1,1): the parity kernels, flattened."""
    if tuple(w.shape[:2]) != (5, 5):
        raise ValueError(f"w must be (5, 5, C, Co), got {tuple(w.shape)}")
    return [k.reshape(-1, w.shape[3]) for _, _, k, _ in phase_kernels_up2(w)]


def interleave_parities(outs, co: int):
    """(N, H, W, Co) outputs of the parities (0,0), (0,1), (1,0), (1,1) ->
    (N, 2H, 2W, Co), out[2i+r, 2j+t] = outs[2r+t][i, j]."""
    n, h, w = outs[0].shape[:3]
    y = torch.stack(outs, dim=3).reshape(n, h, w, 2, 2, co)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h, 2 * w, co)


def conv_transpose_phases_up2(x, w):
    """The 5x5 stride-2 SAME transposed conv as four dense VALID convs, one
    per output parity, interleaved; x NHWC, w (5, 5, C, Co) un-flipped."""
    outs = []
    for _, _, k, (pt, pl) in phase_kernels_up2(w):
        ka, kb = k.shape[0], k.shape[1]
        xp = F.pad(x, (0, 0, pl, kb - 1 - pl, pt, ka - 1 - pt))
        outs.append(F.conv2d(xp.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1).contiguous())
                    .permute(0, 2, 3, 1))
    return interleave_parities(outs, w.shape[3])


def subpixel_kernel_up2(w):
    """A stride-2 transposed-conv kernel (k, k, C, Co), k <= 5, as one dense
    3x3 kernel (3, 3, C, 4 Co), one Co block per output parity (r, t) in the
    order (0,0), (0,1), (1,0), (1,1) (nic_tpu's ``_subpixel_kernel_up2``)."""
    k = w.shape[0]
    if k > 5:
        raise NotImplementedError("subpixel rewrite supports kernels up to 5x5")
    ci, co = w.shape[2], w.shape[3]
    wf = w.flip(0, 1)
    off = k // 2 - 1  # conv_transpose places the flipped kernel at 2q - off
    blocks = []
    for r in range(2):
        for t in range(2):
            kk = w.new_zeros((3, 3, ci, co))
            for a in (-1, 0, 1):
                for b in (-1, 0, 1):
                    m, n = 2 * a + r + off, 2 * b + t + off
                    if 0 <= m < k and 0 <= n < k:
                        kk[1 - a, 1 - b] = wf[m, n]
            blocks.append(kk)
    return torch.cat(blocks, dim=-1)


def depth_to_space2(x4, co: int):
    """(N, H, W, 4 Co) in parity blocks -> (N, 2H, 2W, Co)."""
    n, h, w, _ = x4.shape
    x4 = x4.reshape(n, h, w, 2, 2, co)
    return x4.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h, 2 * w, co)


def _subpixel_conv(x, w):
    """x's SAME 3x3 conv with ``subpixel_kernel_up2(w)``: (N, H, W, 4 Co)."""
    k4 = subpixel_kernel_up2(w)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return F.conv2d(xp.permute(0, 3, 1, 2),
                    k4.permute(3, 2, 0, 1).contiguous()).permute(0, 2, 3, 1)


def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """nic_tpu's initial values for every layer of ``model`` that has them
    (``reset_parameters``), drawn in module order from ``generator``."""
    for module in model.modules():
        reset = getattr(module, "reset_parameters", None)
        if reset is not None:
            reset(generator=generator)
    return model


class SignalConv(nn.Module):
    """2-D convolution with integer down- or up-sampling (NHWC in and out).

    ``strides_down=s`` -> strided conv, output ceil(H/s);
    ``strides_up=s``   -> transposed conv, output sH.

    ``weight`` is stored as the torch op takes it: (out, in, kh, kw) for a
    down or stride-1 conv; (in, out, kh, kw), spatially flipped, for an up
    conv. ``weight_from_hwio`` converts an nic_tpu HWIO kernel.

    ``dtype`` is the computation dtype: the input and the weight are cast to
    it before the conv, and in bfloat16 the bias is added after the conv in
    bfloat16, as nic_tpu adds it; the output is in ``dtype``.

    ``upsample_impl`` picks the form of a stride-2 up-conv: "transpose"
    (default), "phases" (5x5 only) or "subpixel" (k <= 5); see the module's
    docstring. ``quant`` None (default), "int8" (W8A8 forward with a
    straight-through backward, ops/int8conv.py) or "int8_all" (also the
    input cotangent of a 5x5 stride-2 up-conv in int8) applies with
    "transpose" only, for frozen-weight inference loops. ``scale_reduce``,
    when set (data-parallel inference, ``LatentOptimizer``), reduces each
    per-tensor int8 scale's max|x| over the ranks.
    """

    def __init__(self, in_channels: int, features: int, kernel: int = 5,
                 strides_down: int = 1, strides_up: int = 1,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 upsample_impl: str = "transpose", quant: Optional[str] = None):
        super().__init__()
        self.dtype = dtype
        if strides_down > 1 and strides_up > 1:
            raise ValueError("Cannot both down- and up-sample.")
        if upsample_impl not in UPSAMPLE_IMPLS:
            raise ValueError(f"upsample_impl must be one of {UPSAMPLE_IMPLS}, "
                             f"got {upsample_impl!r}")
        if quant not in QUANT_MODES:
            raise ValueError(f"quant must be one of {QUANT_MODES}, got {quant!r}")
        if strides_up == 2 and upsample_impl == "phases" and kernel != 5:
            raise NotImplementedError("phase rewrite is specialized to 5x5 kernels")
        if strides_up == 2 and upsample_impl == "subpixel" and kernel > 5:
            raise NotImplementedError("subpixel rewrite supports kernels up to 5x5")
        self.kernel = kernel
        self.strides_down = strides_down
        self.strides_up = strides_up
        self.transpose = strides_up > 1
        self.upsample_impl = upsample_impl
        self.quant = quant
        self.scale_reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
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

    def hwio(self) -> torch.Tensor:
        """The layer's weight as nic_tpu's (kh, kw, in, out) kernel (a
        transposed conv's un-flipped), differentiable."""
        if self.transpose:
            return self.weight.permute(2, 3, 0, 1).flip(0, 1)
        return self.weight.permute(2, 3, 1, 0)

    def forward(self, x, block_space_output: bool = False, plain: bool = False):
        """``block_space_output``: a stride-2 up-conv's output in 2x2-block
        space, (N, H, W, 4 Co), channel (2r + t) Co + c holding pixel parity
        (r, t): the output modulo depth-to-space (nic_tpu's form for the
        reorder-invariant losses). ``plain``: the float "transpose" form
        whatever the layer's ``upsample_impl`` and ``quant`` (the layers of
        nic_tpu's row-sharded g_s are built so)."""
        n, h, w, _ = x.shape
        x = x.to(self.dtype)
        if block_space_output:
            if self.strides_up != 2:
                raise ValueError("block_space_output requires strides_up=2")
            y4 = _subpixel_conv(x, self.hwio().to(self.dtype))
            if self.bias is not None:
                y4 = y4 + self.bias.to(self.dtype).repeat(4)
            return y4
        impl = "transpose" if plain else self.upsample_impl
        if self.quant is not None and not plain and impl == "transpose":
            from nic_tpu_torch.ops.int8conv import int8_conv, int8_conv_transpose_qbwd

            wq = self.hwio().to(self.dtype)
            reduce = self.scale_reduce
            if self.quant == "int8_all" and self.strides_up == 2 and self.kernel == 5:
                y = int8_conv_transpose_qbwd(x, wq, 2, reduce)
            elif self.transpose:
                y = int8_conv(x, wq, self.strides_up, True, reduce)
            else:
                y = int8_conv(x, wq, self.strides_down, False, reduce)
            y = y.to(self.dtype)
            fused = None
        elif self.strides_up == 2 and impl == "phases":
            y, fused = conv_transpose_phases_up2(x, self.hwio().to(self.dtype)), None
        elif self.strides_up == 2 and impl == "subpixel":
            y4 = _subpixel_conv(x, self.hwio().to(self.dtype))
            y, fused = depth_to_space2(y4, self.weight.shape[1]), None
        else:
            weight = self.weight.to(self.dtype)
            # In float32 cuDNN adds the bias inside the conv; a bfloat16 conv
            # rounds its sum first, and the bias is added to the rounded value.
            fused = self.bias if self.dtype == torch.float32 else None
            if self.transpose:
                y = conv_transpose_same(x, weight, self.strides_up, fused)
            else:
                s, k = self.strides_down, self.kernel
                top, bottom = same_pads(h, k, s)
                left, right = same_pads(w, k, s)
                x = F.pad(x, (0, 0, left, right, top, bottom))
                y = F.conv2d(x.permute(0, 3, 1, 2), weight, fused,
                             stride=s).permute(0, 2, 3, 1)
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
