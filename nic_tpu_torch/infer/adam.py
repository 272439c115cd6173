"""Adam over the latents (counterpart of nic_tpu/infer/adam.py).

Keras-style bias correction folded into the step size, eps added outside
the sqrt, as the reference's numpy Adam. Unlike nic_tpu's functional
update, this one updates the parameters and the moments in place: the
latents and their two moments are the optimization's whole state, and
updating them in place keeps one copy of each on the card. The step size
is computed on the host from the step count, so a step needs no device
value.
"""

import math
from typing import List, NamedTuple, Sequence

import torch


class AdamState(NamedTuple):
    m: List[torch.Tensor]  # first moments
    v: List[torch.Tensor]  # second moments
    t: int                 # number of updates applied


def adam_init(params: Sequence[torch.Tensor]) -> AdamState:
    return AdamState(
        m=[torch.zeros_like(p) for p in params],
        v=[torch.zeros_like(p) for p in params],
        t=0,
    )


@torch.no_grad()
def adam_update(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                state: AdamState, lr: float, beta_1: float = 0.9,
                beta_2: float = 0.999, epsilon: float = 1e-8) -> AdamState:
    """One Adam step on ``params`` in place; returns the new state."""
    t = state.t + 1
    lr_t = lr * math.sqrt(1.0 - beta_2 ** t) / (1.0 - beta_1 ** t)
    for p, g, m, v in zip(params, grads, state.m, state.v):
        m.mul_(beta_1).add_(g, alpha=1.0 - beta_1)
        v.mul_(beta_2).add_(torch.square(g), alpha=1.0 - beta_2)
        p.sub_(lr_t * m / (torch.sqrt(v) + epsilon))
    return AdamState(m=state.m, v=state.v, t=t)
