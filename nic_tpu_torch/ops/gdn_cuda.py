"""K1 on Hopper: the fused GDN/IGDN kernel (``csrc/gdn.cu``, on the tensor
cores: bf16, or fp32 through 3xTF32) and its plain version.

Replaces the Pallas TPU kernel of nic_tpu/ops/pallas_gdn.py (``_gdn_kernel``
through ``gdn_pallas``). The CUDA source has a plain C interface, is built
by ``ops/build.py`` with nvcc at first use and is called through ctypes on
PyTorch's current stream. The backward is ``_gdn_bwd``'s math in plain
torch: in nic_tpu it is XLA matmuls, not a Pallas kernel.

``launches`` counts the kernel's launches, so a run can show that its main
path went through the kernel.
"""

import ctypes

import torch

from nic_tpu_torch.ops.build import build_library

launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library("gdn.cu")))
        lib.nic_gdn_forward.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.nic_gdn_forward.restype = ctypes.c_int
        lib.nic_gdn_max_channels.argtypes = []
        lib.nic_gdn_max_channels.restype = ctypes.c_int
        _lib = lib
    return _lib


def gdn_reference(x, beta, gamma, inverse: bool = False):
    """Plain (I)GDN over the channel-last axis, any rank and dtype.

    y_j = x_j / sqrt(beta_j + sum_i gamma[i, j] * x_i^2)   (inverse: multiply)

    x^2 is rounded to x's dtype and gamma is rounded to x's dtype, as the
    kernel and nic_tpu's ``_gdn_kernel`` (jnp.square) take them; the
    normalizer and the product run in fp32 whatever the activation dtype.
    """
    xf = x.float()
    norm = torch.matmul((x * x).float(), gamma.to(x.dtype).float()) + beta.float()
    scale = torch.sqrt(norm) if inverse else torch.rsqrt(norm)
    return (xf * scale).to(x.dtype)


def gdn_forward_kernel(x2d, gamma, beta, inverse: bool):
    """Launch the kernel on (M, C) rows: x2d and gamma of one dtype (float32
    or bfloat16), beta float32, all contiguous on one CUDA device."""
    global launches
    if not x2d.is_cuda:
        raise ValueError("gdn_forward_kernel takes CUDA tensors")
    if x2d.dtype not in _DTYPE_CODES:
        raise TypeError(f"GDN kernel takes float32 or bfloat16, not {x2d.dtype}")
    if x2d.dim() != 2:
        raise ValueError(f"x must be (M, C), got {tuple(x2d.shape)}")
    rows, channels = x2d.shape
    lib = _library()
    if channels > lib.nic_gdn_max_channels():
        raise ValueError(
            f"GDN kernel takes at most {lib.nic_gdn_max_channels()} channels, "
            f"got {channels}"
        )
    if gamma.dtype != x2d.dtype or gamma.shape != (channels, channels):
        raise ValueError(
            f"gamma must be ({channels}, {channels}) {x2d.dtype}, got "
            f"{tuple(gamma.shape)} {gamma.dtype}"
        )
    if beta.dtype != torch.float32 or beta.shape != (channels,):
        raise ValueError(f"beta must be ({channels},) float32")
    for name, t in (("x", x2d), ("gamma", gamma), ("beta", beta)):
        if t.device != x2d.device:
            raise ValueError(f"{name} is on {t.device}, x on {x2d.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty_like(x2d)
    if rows == 0:
        return out
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.nic_gdn_forward(
            x2d.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
            rows, channels, int(inverse), _DTYPE_CODES[x2d.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"GDN kernel launch failed with cudaError {err}")
    launches += 1
    return out


def gdn_backward(x2d, gamma, beta, g, inverse: bool, need_gamma: bool = True,
                 need_beta: bool = True):
    """Analytic (I)GDN gradient in plain torch: (dx, dgamma, dbeta), the math
    of nic_tpu/ops/pallas_gdn.py ``_gdn_bwd``; dgamma and dbeta are None
    when not needed.

    n = x^2 @ Gamma + beta;  y = x * n^(+-1/2)
    dL/dn_j = +-1/2 * g_j * x_j * n_j^(+-1/2 - 1)
    dL/dx_i = g_i * n_i^(+-1/2) + 2 x_i * (dL/dn @ Gamma^T)_i
    dL/dGamma_ij = sum_m x_mi^2 * dL/dn_mj ; dL/dbeta_j = sum_m dL/dn_mj
    """
    xf = x2d.float()
    gf = g.float()
    gammaf = gamma.float()
    n = torch.matmul(xf * xf, gammaf) + beta.float()
    if inverse:
        half_pow = torch.sqrt(n)
        dn = 0.5 * gf * xf / half_pow
    else:
        half_pow = torch.rsqrt(n)
        dn = -0.5 * gf * xf * half_pow / n
    dx = gf * half_pow + 2.0 * xf * torch.matmul(dn, gammaf.t())
    dgamma = torch.matmul((xf * xf).t(), dn).to(gamma.dtype) if need_gamma else None
    dbeta = dn.sum(dim=0).to(beta.dtype) if need_beta else None
    return dx.to(x2d.dtype), dgamma, dbeta


class GDNKernelFunction(torch.autograd.Function):
    """The kernel's forward with ``gdn_backward`` as its gradient."""

    @staticmethod
    def forward(ctx, x2d, gamma, beta, inverse: bool):
        ctx.save_for_backward(x2d, gamma, beta)
        ctx.inverse = inverse
        return gdn_forward_kernel(x2d, gamma, beta, inverse)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta = ctx.saved_tensors
        dx, dgamma, dbeta = gdn_backward(
            x, gamma, beta, g, ctx.inverse,
            need_gamma=ctx.needs_input_grad[1], need_beta=ctx.needs_input_grad[2],
        )
        return dx, dgamma, dbeta, None


def gdn_kernel(x, beta, gamma, inverse: bool = False):
    """(I)GDN of channel-last CUDA ``x`` of any rank through the kernel."""
    shape = x.shape
    x2d = x.reshape(-1, shape[-1]).contiguous()
    out = GDNKernelFunction.apply(
        x2d, gamma.to(x.dtype).contiguous(), beta.float().contiguous(), inverse
    )
    return out.reshape(shape)
