"""Plain-torch emulation of the operand rounding in the port's tensor-core
kernels (nic_tpu_torch/csrc/tc_tile.cuh, gdn.cu, convt_igdn.cu), for tests
on the CPU: what each route rounds, with fp32 sums.

- bf16 route: bf16 operands, exact products, fp32 sums. K1 squares x in
  bf16 (one rounding, as jnp.square); K2 keeps z in bf16 between its two
  GEMMs, and its normalizer takes z*z (squared in bf16) and gamma in bf16.
- fp32 route (3xTF32): each operand split as v = hi + lo, lo rounded to
  TF32 by cvt.rna (10 mantissa bits, to nearest, ties away from zero) and hi
  too in K2, truncated in K1; a @ b taken as (a_lo b_hi + a_hi b_lo) +
  a_hi b_hi.
"""

import torch
import torch.nn.functional as F

from nic_tpu_torch.ops.convt_igdn import ROW_TILE, phase_taps, phase_weight_mats


def tf32_rna(x):
    """float32 rounded to TF32 as cvt.rna.tf32.f32 does: add half of the
    dropped 13 bits' range to the magnitude and clear them."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_truncate(x):
    """float32 with its low 13 mantissa bits cleared."""
    return (x.float().contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split_tf32(x, round_hi=True):
    """v = hi + lo as tc_tile.cuh's split_tf32<round_hi>: hi rounded by
    cvt.rna (K2) or truncated (K1), lo = v - hi rounded by cvt.rna."""
    hi = tf32_rna(x) if round_hi else tf32_truncate(x)
    return hi, tf32_rna(x.float() - hi)


def matmul_3xtf32(a, b, round_hi=True):
    """a @ b of the kernels' fp32 route. The products of TF32 values are
    exact in fp32."""
    a_hi, a_lo = split_tf32(a, round_hi)
    b_hi, b_lo = split_tf32(b, round_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _scale(norm, inverse):
    rs = torch.rsqrt(norm)
    return norm * rs if inverse else rs


def gdn_emulated(x, beta, gamma, inverse):
    """K1 on (M, C) rows of x (float32 or bfloat16), gamma rounded to x's dtype."""
    if x.dtype == torch.bfloat16:
        norm = (x * x).float() @ gamma.to(torch.bfloat16).float()
    else:
        norm = matmul_3xtf32(x * x, gamma.float(), round_hi=False)
    norm = norm + beta.float()
    return (x.float() * _scale(norm, inverse)).to(x.dtype)


def convt_igdn_emulated(x, w, bias, beta, gamma, inverse=True):
    """K2 as the kernel rounds it: the plain version's phases and im2col, with
    the conv GEMM and the normalizer GEMM of x's route."""
    n, h, wd, c = x.shape
    co = w.shape[3]
    bf16 = x.dtype == torch.bfloat16
    hp = -(-h // ROW_TILE) * ROW_TILE
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1 + hp - h))
    mats = phase_weight_mats(w.to(x.dtype).float())
    gamma_op = gamma.to(torch.bfloat16).float() if bf16 else gamma.float()
    phases = []
    for r in range(2):
        for t in range(2):
            a_taps, b_taps = phase_taps(r, t)
            cols = [xp[:, 1 - a: 1 - a + hp, 1 - b: 1 - b + wd, :]
                    for a in a_taps for b in b_taps]
            xcat = torch.cat(cols, dim=-1).reshape(-1, len(cols) * c)
            mat = mats[2 * r + t]
            z = (xcat @ mat if bf16 else matmul_3xtf32(xcat, mat)) + bias.float()
            if bf16:  # z kept in bf16 between the GEMMs, squared in bf16
                z = z.to(torch.bfloat16)
                norm = (z * z).float() @ gamma_op
                z = z.float()
            else:
                norm = matmul_3xtf32(z * z, gamma_op)
            y = z * _scale(norm + beta.float(), inverse)
            phases.append(y.reshape(n, hp, wd, co))
    y = torch.stack(phases, dim=3).reshape(n, hp, wd, 2, 2, co)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * hp, 2 * wd, co)
    return y[:, : 2 * h].to(x.dtype)


def committed_gs_layers(crop=128):
    """The three 192 -> 192 up-conv + IGDN layers of g_s in the committed
    lambda = 0.01 MBT2018 checkpoint, fed a crop x crop corner of the first
    photo of data_real/eval_photos.npy: for each, its NHWC input x, the HWIO
    kernel w (nic_tpu's un-flipped layout), bias, the IGDN's beta and gamma,
    and the conv output z that the IGDN normalizes (N*H*W, C)."""
    import os

    import numpy as np

    from nic_tpu_torch.checkpoint import load_model

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    _, model = load_model(os.path.join(root, "checkpoints_synth3"),
                          "mbt2018-num_filters=192-lmbda=0.01", 192, "cpu")
    photo = np.load(os.path.join(root, "data_real", "eval_photos.npy"))[:1, :crop, :crop]
    x = torch.from_numpy(photo.astype(np.float32) / 255.0)
    layers = []
    with torch.no_grad():
        h = model(x)["y_tilde"]
        for i in range(3):
            conv = getattr(model.synthesis, f"layer_{i}")
            igdn = getattr(model.synthesis, f"igdn_{i}")
            beta, gamma = igdn.effective_params()
            z = conv(h)
            layers.append(dict(x=h, w=conv.weight.permute(2, 3, 0, 1).flip(0, 1).contiguous(),
                               bias=conv.bias, beta=beta, gamma=gamma,
                               z=z.reshape(-1, z.shape[-1])))
            h = igdn(z)
    return layers
