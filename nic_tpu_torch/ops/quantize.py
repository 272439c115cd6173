"""SGA relaxation of rounding (counterpart of nic_tpu/ops/quantize.py).

Only the stochastic Gumbel annealing of the SGA method is ported; the STE
rounds and the deterministic annealing relaxation come with the other
methods (ROADMAP.md).
"""

from typing import Optional

import torch

from nic_tpu_torch.config import ATANH_EPSILON


def sga_logits(v, temperature):
    """Boltzmann logits for rounding DOWN vs UP.

    For each latent element v with fractional position f = v - floor(v), the
    logits are (-atanh(f)/T, -atanh(1-f)/T); clipping prevents NaN as T -> 0.
    Returns ``(v_floor, v_ceil, logits)`` with logits stacked on a new last
    axis.
    """
    v_floor = torch.floor(v)
    v_ceil = torch.ceil(v)
    down = -torch.atanh(
        torch.clamp(v - v_floor, -1 + ATANH_EPSILON, 1 - ATANH_EPSILON)
    ) / temperature
    up = -torch.atanh(
        torch.clamp(v_ceil - v, -1 + ATANH_EPSILON, 1 - ATANH_EPSILON)
    ) / temperature
    return v_floor, v_ceil, torch.stack([down, up], dim=-1)


def draw_gumbel(shape, generator: torch.Generator, device, dtype=torch.float32):
    """Gumbel(0, 1) draws, -log(-log U) with U in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    u = torch.clamp_min(u, torch.finfo(dtype).tiny)
    return -torch.log(-torch.log(u))


def sga_relax(v, temperature, generator: Optional[torch.Generator] = None,
              gumbel: Optional[torch.Tensor] = None):
    """Stochastic Gumbel annealing relaxation of rounding.

    Samples a relaxed one-hot (Gumbel-softmax) vector over {floor, ceil} at
    the given temperature and returns ``p_down * floor(v) + p_up * ceil(v)``;
    as T -> 0 this converges to round(v). The Gumbel noise, of shape
    ``v.shape + (2,)``, is drawn from ``generator`` unless ``gumbel`` gives
    it (tests feed JAX's draws this way).
    """
    v_floor, v_ceil, logits = sga_logits(v, temperature)
    if gumbel is None:
        if generator is None:
            raise ValueError("sga_relax needs a generator or gumbel draws")
        gumbel = draw_gumbel(logits.shape, generator, v.device, v.dtype)
    sample = torch.softmax((logits + gumbel) / temperature, dim=-1)
    return v_floor * sample[..., 0] + v_ceil * sample[..., 1]
