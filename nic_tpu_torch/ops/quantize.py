"""Quantization surrogates: STE rounds, the SGA and deterministic annealing
relaxations, and additive uniform noise (counterpart of
nic_tpu/ops/quantize.py).

Random draws come from a ``torch.Generator`` unless the caller passes them
(tests feed JAX's draws this way).
"""

from typing import Optional

import torch

from nic_tpu_torch.config import ATANH_EPSILON


class _RoundSTE(torch.autograd.Function):
    """round(x) forward; the gradient passes through ``grad_fn``."""

    @staticmethod
    def forward(ctx, x, grad_fn):
        ctx.grad_fn = grad_fn
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.grad_fn(g), None


def round_ste(x):
    """round(x) with the identity as its gradient."""
    return _RoundSTE.apply(x, lambda g: g)


def round_relu_ste(x):
    """round(x) with relu(grad) as its gradient."""
    return _RoundSTE.apply(x, torch.relu)


def round_crelu_ste(x):
    """round(x) with clip(relu(grad), 0, 1) as its gradient."""
    return _RoundSTE.apply(x, lambda g: torch.clamp(torch.relu(g), 0.0, 1.0))


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


def danneal_relax(v, temperature):
    """Deterministic annealing: the expectation instead of a sample, a
    softmax over the same Boltzmann logits with no Gumbel noise and no
    second division by T."""
    v_floor, v_ceil, logits = sga_logits(v, temperature)
    p = torch.softmax(logits, dim=-1)
    return v_floor * p[..., 0] + v_ceil * p[..., 1]


def draw_uniform(shape, generator: torch.Generator, device, dtype=torch.float32):
    """U(-0.5, 0.5) draws."""
    return torch.rand(shape, generator=generator, device=device, dtype=dtype) - 0.5


def uniform_noise(v, generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None):
    """v + U(-0.5, 0.5), the draws taken from ``generator`` unless ``noise``
    gives them (of v's shape)."""
    if noise is None:
        if generator is None:
            raise ValueError("uniform_noise needs a generator or noise draws")
        noise = draw_uniform(v.shape, generator, v.device, v.dtype)
    return v + noise
