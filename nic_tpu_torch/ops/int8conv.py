"""Dynamically quantized int8 convolutions, W8A8, for the frozen-weight
inference loops (counterpart of nic_tpu/ops/int8conv.py).

The scheme is nic_tpu's:
  - weights: symmetric int8 with one scale per output channel;
  - activations: symmetric int8 per tensor, scale max|x| / 127 computed at
    every call, in the input's own dtype (bfloat16 for the bf16 transforms),
    then round(x / s) half to even, clipped to +-127;
  - products summed in int32, exactly; the sum cast to bfloat16 and
    multiplied by the bfloat16 scale sx * sw, in that order.
The backward is straight-through: the gradient of the same conv in x's
dtype with the original weights. ``int8_conv_transpose_qbwd`` also runs the
input cotangent of the 5x5 stride-2 up-conv in int8 (the cotangent
quantized per tensor); its weight gradient stays float and is computed only
when asked for.

nic_tpu runs these convs through XLA. Here each is an im2col product on
``torch._int_mm`` (cuBLASLt's int8 GEMM on the card, with exact int32
accumulation; the same call on the CPU): the quantized input's taps are
gathered in int8, then one GEMM over the k*k taps for a strided conv, and
for the 5x5 stride-2 up-conv four GEMMs, one per output parity
(``phase_taps`` of models/layers.py), interleaved. A float conv of the
integer values is never taken: its sums can pass 2^24. Channels are
zero-padded to a multiple of 8 and rows to more than 16, as cuBLASLt's int8
GEMM asks; zeros add nothing to an integer sum.

``reduce_max`` (data-parallel inference) maps a per-tensor max|x| to its
maximum over the ranks, so that a rank holding part of a batch quantizes
with the whole batch's scale, as nic_tpu's jit over a sharded batch does.
"""

from typing import Callable, Optional

import torch

from nic_tpu_torch.models.layers import (
    conv_transpose_pads,
    interleave_parities,
    phase_taps,
    phase_weight_mats,
    same_pads,
)

ReduceMax = Optional[Callable[[torch.Tensor], torch.Tensor]]
INT8_MAX = 127
# cuBLASLt's int8 GEMM wants K and N multiples of 8, and more than 16 rows.
ALIGN = 8
MIN_ROWS = 17
PARITIES = ((0, 0), (0, 1), (1, 0), (1, 1))


def quantize_per_tensor(x, reduce_max: ReduceMax = None):
    """(int8 q, scale s): s = max(max|x|, 1e-12) / 127 in x's dtype."""
    amax = torch.amax(torch.abs(x))
    if reduce_max is not None:
        amax = reduce_max(amax)
    s = torch.clamp_min(amax, 1e-12) / INT8_MAX
    q = torch.clamp(torch.round(x / s), -INT8_MAX, INT8_MAX).to(torch.int8)
    return q, s


def quantize_weight_per_cout(w):
    """Symmetric int8 with one scale per output channel (w: [kh, kw, ci, co]);
    the scales are [co]."""
    s = torch.clamp_min(torch.amax(torch.abs(w), dim=(0, 1, 2)), 1e-12) / INT8_MAX
    q = torch.clamp(torch.round(w / s), -INT8_MAX, INT8_MAX).to(torch.int8)
    return q, s


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _int_mm(a, b):
    """a [M, K] int8 @ b [K, N] int8 -> [M, N] int32, rows padded to MIN_ROWS;
    a row-major and b column-major, the layout of cuBLASLt's int8 GEMM."""
    m = a.shape[0]
    if m < MIN_ROWS:
        a = torch.cat([a, a.new_zeros((MIN_ROWS - m, a.shape[1]))])
    return torch._int_mm(a, b.t().contiguous().t())[:m]


def _padded(q, top: int, bottom: int, left: int, right: int, channels: int):
    """q (N, H, W, C) zero-padded in H and W and to ``channels`` channels."""
    n, h, w, c = q.shape
    out = q.new_zeros((n, h + top + bottom, w + left + right, channels))
    out[:, top: top + h, left: left + w, :c] = q
    return out


def _padded_weight(wq, channels: int, features: int):
    """wq (kh, kw, C, Co) zero-padded to (kh, kw, channels, features)."""
    kh, kw, c, co = wq.shape
    out = wq.new_zeros((kh, kw, channels, features))
    out[:, :, :c, :co] = wq
    return out


def _im2col(xp, taps, ho: int, wo: int, stride: int):
    """[N * ho * wo, len(taps) * C]: row (n, i, j) holds xp[n, stride*i + dy,
    stride*j + dx, :] for each tap (dy, dx), taps in the given order."""
    n, c = xp.shape[0], xp.shape[3]
    cols = [xp[:, dy: dy + stride * (ho - 1) + 1: stride,
               dx: dx + stride * (wo - 1) + 1: stride] for dy, dx in taps]
    return torch.stack(cols, dim=3).reshape(n * ho * wo, len(taps) * c)


def _correlate(q, wq, stride: int, pads):
    """int32 (N, Ho, Wo, Co): the strided correlation of int8 q (N, H, W, C)
    padded by ``pads`` = ((top, bottom), (left, right)) with int8 wq
    (kh, kw, C, Co), as one GEMM over the kh*kw taps."""
    (top, bottom), (left, right) = pads
    kh, kw, c, co = wq.shape
    cp, cop = _round_up(c, ALIGN), _round_up(co, ALIGN)
    xp = _padded(q, top, bottom, left, right, cp)
    ho = (xp.shape[1] - kh) // stride + 1
    wo = (xp.shape[2] - kw) // stride + 1
    a = _im2col(xp, [(i, j) for i in range(kh) for j in range(kw)], ho, wo, stride)
    b = _padded_weight(wq, cp, cop).reshape(kh * kw * cp, cop)
    return _int_mm(a, b)[:, :co].reshape(q.shape[0], ho, wo, co)


def _transpose_up2(q, wq):
    """int32 (N, 2H, 2W, Co): XLA's SAME 5x5 stride-2 transposed conv of int8
    q with int8 wq (5, 5, C, Co), as four parity GEMMs."""
    n, h, w, c = q.shape
    co = wq.shape[3]
    cp, cop = _round_up(c, ALIGN), _round_up(co, ALIGN)
    xp = _padded(q, 1, 1, 1, 1, cp)  # taps a, b in {-1, 0, 1}
    outs = []
    for (r, t), mat in zip(PARITIES, phase_weight_mats(_padded_weight(wq, cp, cop))):
        a_taps, b_taps = phase_taps(r, t)
        a = _im2col(xp, [(1 - ta, 1 - tb) for ta in a_taps for tb in b_taps], h, w, 1)
        outs.append(_int_mm(a, mat)[:, :co].reshape(n, h, w, co))
    return interleave_parities(outs, co)


def _transpose_dilated(q, wq, stride: int):
    """int32: XLA's SAME transposed conv of any other shape, as XLA defines
    it: the input dilated by ``stride``, padded (pad_a, pad_b), correlated
    with the un-flipped kernel."""
    k = wq.shape[0]
    pad_a = k - 1 - conv_transpose_pads(k, stride)[0]
    pad_b = k + stride - 2 - pad_a
    n, h, w, c = q.shape
    xd = q.new_zeros((n, (h - 1) * stride + 1, (w - 1) * stride + 1, c))
    xd[:, ::stride, ::stride] = q
    return _correlate(xd, wq, 1, ((pad_a, pad_b), (pad_a, pad_b)))


def conv_int32(q, wq, stride: int, transpose: bool):
    """The int32 sums of the SAME conv (or transposed conv) of int8 q (NHWC)
    with int8 wq (HWIO), exact."""
    k = wq.shape[0]
    if not transpose:
        pads = (same_pads(q.shape[1], k, stride), same_pads(q.shape[2], wq.shape[1], stride))
        return _correlate(q, wq, stride, pads)
    if (tuple(wq.shape[:2]), stride) == ((5, 5), 2):
        return _transpose_up2(q, wq)
    return _transpose_dilated(q, wq, stride)


def _rescale(acc, sx, sw):
    """int32 sums -> bfloat16, times the bfloat16 scale sx * sw ([co])."""
    return acc.to(torch.bfloat16) * (sx * sw).to(torch.bfloat16)


def qfwd(x, w, stride: int, transpose: bool, reduce_max: ReduceMax = None):
    """The int8 forward: x (NHWC) and w (HWIO) quantized, the int32 conv,
    rescaled to bfloat16."""
    xq, sx = quantize_per_tensor(x, reduce_max)
    wq, sw = quantize_weight_per_cout(w)
    return _rescale(conv_int32(xq, wq, stride, transpose), sx, sw)


def adjoint_weight_up2(w):
    """Kernel of the input-cotangent conv of the 5x5 stride-2 SAME
    transposed conv: dx = conv(g, rot180(w) with in and out swapped,
    stride 2, pad (1, 2))."""
    return w.permute(0, 1, 3, 2).flip(0, 1)


def qbwd_x_up2(g, w, stride: int = 2, reduce_max: ReduceMax = None):
    """The int8 input cotangent of the 5x5 stride-2 up-conv, bfloat16."""
    wt = adjoint_weight_up2(w)
    gq, sg = quantize_per_tensor(g, reduce_max)
    wq, sw = quantize_weight_per_cout(wt)
    return _rescale(_correlate(gq, wq, stride, ((1, 2), (1, 2))), sg, sw)


def float_conv_vjp(x, w, g, stride: int, transpose: bool, need_x: bool = True,
                   need_w: bool = True):
    """(dx, dw) of the SAME conv (or transposed conv) of x (NHWC) with w
    (HWIO) in x's dtype, at cotangent g: the convolution's own backward
    (``aten.convolution_backward``, as autograd calls it), no forward rerun.
    An entry not asked for is None."""
    g = g.to(x.dtype)
    n, h, wd, _ = x.shape
    k = w.shape[0]
    mask = [need_x, need_w, False]
    if transpose:
        weight = w.flip(0, 1).permute(2, 3, 0, 1)
        pad, out_pad = conv_transpose_pads(k, stride)
        full_h = (h - 1) * stride - 2 * pad + k + out_pad
        full_w = (wd - 1) * stride - 2 * pad + k + out_pad
        g_full = g.new_zeros((n, full_h, full_w, g.shape[3]))
        g_full[:, : stride * h, : stride * wd] = g
        dx, dweight, _ = torch.ops.aten.convolution_backward(
            g_full.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), weight, None,
            [stride, stride], [pad, pad], [1, 1], True, [out_pad, out_pad], 1, mask)
        dx = dx.permute(0, 2, 3, 1) if need_x else None
        dw = dweight.permute(2, 3, 0, 1).flip(0, 1) if need_w else None
        return dx, dw
    top, bottom = same_pads(h, k, stride)
    left, right = same_pads(wd, w.shape[1], stride)
    xp = torch.nn.functional.pad(x, (0, 0, left, right, top, bottom))
    dxp, dweight, _ = torch.ops.aten.convolution_backward(
        g.permute(0, 3, 1, 2), xp.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), None,
        [stride, stride], [0, 0], [1, 1], False, [0, 0], 1, mask)
    dx = dxp.permute(0, 2, 3, 1)[:, top: top + h, left: left + wd] if need_x else None
    dw = dweight.permute(2, 3, 1, 0) if need_w else None
    return dx, dw


class _Int8Conv(torch.autograd.Function):
    """int8 forward; straight-through backward, or with ``qbwd`` the int8
    input cotangent of a 5x5 stride-2 up-conv."""

    @staticmethod
    def forward(ctx, x, w, stride, transpose, qbwd, reduce_max):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, transpose, qbwd, reduce_max)
        return qfwd(x, w, stride, transpose, reduce_max)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, transpose, qbwd, reduce_max = ctx.conf
        need_x, need_w = ctx.needs_input_grad[:2]
        if qbwd and transpose and stride == 2 and tuple(w.shape[:2]) == (5, 5):
            dx = qbwd_x_up2(g, w, stride, reduce_max).to(x.dtype) if need_x else None
            dw = None
            if need_w:
                _, dw = float_conv_vjp(x, w, g, stride, True, need_x=False)
        else:
            dx, dw = float_conv_vjp(x, w, g, stride, transpose, need_x, need_w)
        return dx, dw, None, None, None, None


def int8_conv(x, w, strides: int = 1, transpose: bool = False,
              reduce_max: ReduceMax = None):
    """int8-forward conv (or transposed conv) with the straight-through
    backward. x: [N, H, W, Ci] (any float dtype), w: [kh, kw, Ci, Co];
    returns bfloat16."""
    return _Int8Conv.apply(x, w, strides, transpose, False, reduce_max)


def int8_conv_transpose_qbwd(x, w, strides: int = 2, reduce_max: ReduceMax = None):
    """int8 transposed conv whose input cotangent, for the 5x5 stride-2
    shape, is also an int8 conv (other shapes: the straight-through
    backward); returns bfloat16."""
    return _Int8Conv.apply(x, w, strides, True, True, reduce_max)
