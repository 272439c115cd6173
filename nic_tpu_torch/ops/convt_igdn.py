"""K2 on Hopper: fused 5x5 stride-2 transposed conv + bias + (I)GDN
(``csrc/convt_igdn.cu``), its plain version, the composite it replaces, and
``fused_synthesis_layer`` (kernel forward, composite backward).

Replaces the Pallas TPU kernel of nic_tpu/ops/pallas_convt.py (``_kernel``
through ``conv_transpose_igdn_up2``). Layouts are the JAX package's at every
public function: x NHWC, w HWIO (5, 5, C, Co) un-flipped, as
``lax.conv_transpose(x, w, (2, 2), "SAME")`` takes it.

The transposed conv is four output-parity GEMMs (``phase_taps`` and
``phase_weight_mats`` of models/layers.py):
out[2i+r, 2j+t] = sum_{a,b} x[i-a, j-b] @ wf[2a+r+1, 2b+t+1] with
wf = w[::-1, ::-1], and 4/6/6/9 live taps for the
parities (0,0)/(0,1)/(1,0)/(1,1). The kernel runs them on the tensor
cores (bf16, or fp32 through 3xTF32) and reads its weights and gamma
pre-packed by ``pack_weights`` and ``pack_gamma``. The CUDA source has a
plain C interface, is built by ``ops/build.py`` with nvcc at first use and
is called through ctypes on PyTorch's current stream.

``launches`` counts the kernel's launches, so a run can show that its path
went through the kernel.
"""

import ctypes

import torch
import torch.nn.functional as F

from nic_tpu_torch.models.layers import conv_transpose_up2, phase_taps, phase_weight_mats
from nic_tpu_torch.ops.build import build_library
from nic_tpu_torch.ops.gdn_cuda import gdn_reference

launches = 0
# K per pipeline stage of the kernel (64 bytes of each pixel's row): each
# tap's C rows of the packed weights are zero-padded to a multiple of it.
K_CHUNK = {torch.float32: 16, torch.bfloat16: 32}
# The packed weights' and gamma's Co is zero-padded to a multiple of this
# (4 warps x 16 columns of MMA tiles).
CO_ALIGN = 64
# The plain version pads rows to a multiple of nic_tpu's default row tile,
# as the Pallas kernel does, and crops them after.
ROW_TILE = 8

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library("convt_igdn.cu")))
        lib.nic_convt_igdn_forward.argtypes = [
            *([ctypes.c_void_p] * 6), *([ctypes.c_int] * 9), ctypes.c_void_p,
        ]
        lib.nic_convt_igdn_forward.restype = ctypes.c_int
        lib.nic_convt_igdn_max_channels.argtypes = []
        lib.nic_convt_igdn_max_channels.restype = ctypes.c_int
        _lib = lib
    return _lib


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def pack_weights(w, dtype):
    """K2's weight operand: the four parities' ``phase_weight_mats`` of a
    (5, 5, C, Co) kernel, one after the other, with each tap's C rows
    zero-padded to a multiple of ``K_CHUNK[dtype]`` and Co to a multiple of
    ``CO_ALIGN``, in ``dtype``: a contiguous [25 * cpad, cop] matrix whose
    K-chunks the kernel streams as rows."""
    c, co = w.shape[2], w.shape[3]
    cpad, cop = _round_up(c, K_CHUNK[dtype]), _round_up(co, CO_ALIGN)
    wp = F.pad(w.to(dtype), (0, cop - co, 0, cpad - c))
    return torch.cat(phase_weight_mats(wp), dim=0).contiguous()


def pack_gamma(gamma, dtype):
    """The normalizer's B operand: gamma (Co, Co) zero-padded to (cop, cop)
    in ``dtype`` (bfloat16: rounded, as the bf16 route's normalizer GEMM
    takes it)."""
    co = gamma.shape[0]
    cop = _round_up(co, CO_ALIGN)
    return F.pad(gamma.float(), (0, cop - co, 0, cop - co)).to(dtype).contiguous()


def conv_transpose_igdn_up2_reference(x, w, bias, beta, gamma, inverse=True):
    """The composite K2 replaces: SAME transposed conv in x's dtype, + bias,
    then (I)GDN with gamma rounded to the activation dtype (as
    nic_tpu's reference does; the kernel keeps gamma in float32)."""
    weight = w.to(x.dtype).flip(0, 1).permute(2, 3, 0, 1)
    y = conv_transpose_up2(x, weight)
    y = y + bias.to(y.dtype)
    return gdn_reference(y, beta, gamma.to(y.dtype), inverse)


def conv_transpose_igdn_up2_plain(x, w, bias, beta, gamma, inverse=True):
    """K2's own formulation in plain torch: pad 1 on every side (and rows up
    to a multiple of ``ROW_TILE``), the four parity im2col matrices, four
    matmuls, + bias, (I)GDN, parities interleaved, rows cropped to 2H. x and
    w of one dtype in, x's dtype out.

    It computes in float64 on the operands as given (x and w in their
    dtype, bias, beta and gamma in float32), so that as the kernel's
    reference its own rounding stays far below the kernel's. Computed in
    float32, on the GDN of the committed checkpoint's second g_s layer on
    an H100, it sat 7.5e-6 to 8.4e-6 of the largest output from a float64
    evaluation (the kernel 1.7e-6 to 2.3e-6), and its difference from the
    kernel reached 1.6e-5, past the float32 tolerance of 1e-5."""
    n, h, wd, c = x.shape
    co = w.shape[3]
    hp = -(-h // ROW_TILE) * ROW_TILE
    xp = F.pad(x.double(), (0, 0, 1, 1, 1, 1 + hp - h))
    mats = phase_weight_mats(w.to(x.dtype).double())
    gamma = gamma.float().double()
    beta = beta.float().double()
    phases = []
    for r in range(2):
        for t in range(2):
            a_taps, b_taps = phase_taps(r, t)
            cols = [xp[:, 1 - a: 1 - a + hp, 1 - b: 1 - b + wd, :]
                    for a in a_taps for b in b_taps]
            xcat = torch.cat(cols, dim=-1).reshape(-1, len(cols) * c)
            z = torch.matmul(xcat, mats[2 * r + t]) + bias.float().double()
            norm = torch.matmul(z * z, gamma) + beta
            z = z * (torch.sqrt(norm) if inverse else torch.rsqrt(norm))
            phases.append(z.reshape(n, hp, wd, co))
    y = torch.stack(phases, dim=3).reshape(n, hp, wd, 2, 2, co)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * hp, 2 * wd, co)
    return y[:, : 2 * h].to(x.dtype)


def convt_igdn_forward_kernel(x, w, bias, beta, gamma, inverse: bool):
    """Launch K2: x (N, H, W, C) and w (5, 5, C, Co) of one dtype (float32
    or bfloat16), bias and beta (Co,) and gamma (Co, Co) float32, on one
    CUDA device, x contiguous. Packs w and gamma (``pack_weights``,
    ``pack_gamma``) and returns (N, 2H, 2W, Co) in x's dtype."""
    if not x.is_cuda:
        raise ValueError("convt_igdn_forward_kernel takes CUDA tensors")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"K2 takes float32 or bfloat16, not {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, C), got {tuple(x.shape)}")
    c = x.shape[3]
    if w.dim() != 4 or tuple(w.shape[:3]) != (5, 5, c) or w.dtype != x.dtype:
        raise ValueError(f"w must be (5, 5, {c}, Co) {x.dtype}, got "
                         f"{tuple(w.shape)} {w.dtype}")
    co = w.shape[3]
    if gamma.dtype != torch.float32 or tuple(gamma.shape) != (co, co):
        raise ValueError(f"gamma must be ({co}, {co}) float32, got "
                         f"{tuple(gamma.shape)} {gamma.dtype}")
    # The packed launch checks the rest, devices and layouts included.
    return convt_igdn_packed_forward(x, pack_weights(w, x.dtype), bias, beta,
                                     pack_gamma(gamma, x.dtype), co, inverse)


def convt_igdn_packed_forward(x, wp, bias, beta, gp, co: int, inverse: bool):
    """Launch K2 on packed operands: x (N, H, W, C), ``wp = pack_weights(w,
    x.dtype)``, bias and beta (Co,) float32, ``gp = pack_gamma(gamma,
    x.dtype)``, all contiguous on x's CUDA device."""
    global launches
    if not x.is_cuda:
        raise ValueError("convt_igdn_packed_forward takes CUDA tensors")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"K2 takes float32 or bfloat16, not {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, C), got {tuple(x.shape)}")
    n, h, wd, c = x.shape
    lib = _library()
    if co > lib.nic_convt_igdn_max_channels():
        raise ValueError(f"K2 takes at most {lib.nic_convt_igdn_max_channels()} "
                         f"output channels, got {co}")
    cpad, cop = _round_up(c, K_CHUNK[x.dtype]), _round_up(co, CO_ALIGN)
    for name, t, shape, dtype in (("packed w", wp, (25 * cpad, cop), x.dtype),
                                  ("packed gamma", gp, (cop, cop), x.dtype),
                                  ("bias", bias, (co,), torch.float32),
                                  ("beta", beta, (co,), torch.float32)):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for name, t in (("x", x), ("packed w", wp), ("bias", bias), ("beta", beta),
                    ("packed gamma", gp)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if 4 * n * h * wd * max(c, co) >= 2 ** 31:
        raise ValueError("K2 takes tensors of fewer than 2^31 elements")
    out = torch.empty((n, 2 * h, 2 * wd, co), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.nic_convt_igdn_forward(
            x.data_ptr(), wp.data_ptr(), bias.data_ptr(), beta.data_ptr(),
            gp.data_ptr(), out.data_ptr(), n, h, wd, c, cpad, co, cop, int(inverse),
            _DTYPE_CODES[x.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"K2 launch failed with cudaError {err}")
    launches += 1
    return out


def conv_transpose_igdn_up2(x, w, bias, beta, gamma, inverse=True):
    """Fused conv_transpose(5x5, stride 2, SAME) + bias + (I)GDN,
    x [N,H,W,C] -> [N,2H,2W,Co]: K2 for a CUDA tensor (it launches or
    raises), the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return conv_transpose_igdn_up2_plain(x, w, bias, beta, gamma, inverse)
    if x.device.type != "cuda":
        raise ValueError(f"K2 runs on cuda or cpu tensors, not {x.device}")
    return convt_igdn_forward_kernel(
        x.contiguous(), w.to(x.dtype).contiguous(), bias.float().contiguous(),
        beta.float().contiguous(), gamma.float().contiguous(), inverse,
    )


class FusedSynthesisLayer(torch.autograd.Function):
    """K2's forward; the backward is autograd through the composite,
    recomputed from the saved inputs (nic_tpu's ``_fsl_bwd``)."""

    @staticmethod
    def forward(ctx, x, w, bias, beta, gamma, inverse):
        ctx.save_for_backward(x, w, bias, beta, gamma)
        ctx.inverse = inverse
        return conv_transpose_igdn_up2(x, w, bias, beta, gamma, inverse)

    @staticmethod
    def backward(ctx, gy):
        saved = ctx.saved_tensors
        needed = ctx.needs_input_grad[:5]
        inputs = [t.detach().requires_grad_(need) for t, need in zip(saved, needed)]
        wrt = [t for t, need in zip(inputs, needed) if need]
        grads = iter(())
        if wrt:
            with torch.enable_grad():
                y = conv_transpose_igdn_up2_reference(*inputs, inverse=ctx.inverse)
            grads = iter(torch.autograd.grad(y, wrt, gy))
        return (*(next(grads) if need else None for need in needed), None)


def fused_synthesis_layer(x, w, bias, beta, gamma, inverse=True):
    """K2 forward (plain version on the CPU) with the composite's gradients
    for x, w, bias, beta and gamma."""
    return FusedSynthesisLayer.apply(x, w, bias, beta, gamma, inverse)
