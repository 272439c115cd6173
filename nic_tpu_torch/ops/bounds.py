"""Bounded min/max with gradient control (counterpart of nic_tpu/ops/bounds.py).

The ``identity_if_towards`` mode passes gradients only when a descent step
would move the input back toward the feasible region; this keeps latents
from getting stuck once a likelihood or variance bound clips them. It is
the default, and every likelihood bound of the rate uses it.
"""

import torch


class _LowerBoundIIT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound: float):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        # Pass the gradient iff the input is feasible, or the gradient pushes
        # the input up toward the bound.
        pass_through = (x >= ctx.bound) | (g < 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


class _UpperBoundIIT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound: float):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_max(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        pass_through = (x <= ctx.bound) | (g > 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


class _LowerBoundIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound: float):
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _UpperBoundIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound: float):
        return torch.clamp_max(x, bound)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _bound_tensor(x, bound: float):
    return torch.full((), bound, dtype=x.dtype, device=x.device)


def lower_bound(x, bound: float, gradient: str = "identity_if_towards"):
    """``maximum(x, bound)`` with a configurable gradient."""
    if gradient == "identity_if_towards":
        return _LowerBoundIIT.apply(x, float(bound))
    if gradient == "identity":
        return _LowerBoundIdentity.apply(x, float(bound))
    if gradient == "disconnected":
        return torch.maximum(x, _bound_tensor(x, bound))
    raise ValueError(f"Invalid gradient mode: {gradient!r}")


def upper_bound(x, bound: float, gradient: str = "identity_if_towards"):
    """``minimum(x, bound)`` with a configurable gradient."""
    if gradient == "identity_if_towards":
        return _UpperBoundIIT.apply(x, float(bound))
    if gradient == "identity":
        return _UpperBoundIdentity.apply(x, float(bound))
    if gradient == "disconnected":
        return torch.minimum(x, _bound_tensor(x, bound))
    raise ValueError(f"Invalid gradient mode: {gradient!r}")
