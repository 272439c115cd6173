"""Deep factorized prior / entropy bottleneck for the hyper-latent z
(counterpart of nic_tpu/models/factorized_prior.py; the parts the SGA path
needs: the CDF network, the likelihood, the medians and quantization).

The density: a monotone map built from K+1 stages
  u <- softplus(H_k) @ u + b_k ;  u <- u + tanh(a_k) * tanh(u)  (k < K)
whose sigmoid is the CDF. Each channel has its own parameters, stored in
nic_tpu's (C, ., .) shapes; the batch rides along the last axis of a
(C, d, N) tensor so every stage is one batched matmul.
"""

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from nic_tpu_torch.config import LIKELIHOOD_LOWER_BOUND


def _channels_to_front(x):
    """(..., C) -> (C, 1, N)."""
    return x.movedim(-1, 0).reshape(x.shape[-1], 1, -1)


def _channels_to_back(flat, shape):
    return flat.reshape((shape[-1],) + tuple(shape[:-1])).movedim(0, -1)


class FactorizedEntropyModel(nn.Module):
    """Learned factorized prior with learned quantiles (tail, median, tail)."""

    def __init__(self, channels: int, dims: Tuple[int, ...] = (3, 3, 3),
                 init_scale: float = 10.0,
                 likelihood_bound: float = LIKELIHOOD_LOWER_BOUND):
        super().__init__()
        self.dims = tuple(dims)
        self.likelihood_bound = likelihood_bound
        filters = (1,) + self.dims + (1,)
        scale = init_scale ** (1.0 / (len(self.dims) + 1))
        for i in range(len(self.dims) + 1):
            init = math.log(math.expm1(1.0 / scale / filters[i + 1]))
            self.register_parameter(f"matrix_{i}", nn.Parameter(
                torch.full((channels, filters[i + 1], filters[i]), init)))
            bias = torch.empty(channels, filters[i + 1], 1)
            nn.init.uniform_(bias, -0.5, 0.5)
            self.register_parameter(f"bias_{i}", nn.Parameter(bias))
            if i < len(self.dims):
                self.register_parameter(f"factor_{i}", nn.Parameter(
                    torch.zeros(channels, filters[i + 1], 1)))
        q = torch.tensor([-init_scale, 0.0, init_scale])
        self.quantiles = nn.Parameter(q.expand(channels, 1, 3).clone())

    def _logits_cdf(self, u):
        """CDF logits for u of shape (C, d, N)."""
        logits = u
        k = len(self.dims)
        for i in range(k + 1):
            m = F.softplus(getattr(self, f"matrix_{i}"))
            logits = torch.matmul(m, logits) + getattr(self, f"bias_{i}")
            if i < k:
                f = torch.tanh(getattr(self, f"factor_{i}"))
                logits = logits + f * torch.tanh(logits)
        return logits

    def likelihood(self, x):
        """P(x - .5 < X <= x + .5), channels-last: a sign-stabilized
        difference of sigmoids, both ends evaluated in whichever tail keeps
        the subtraction well-conditioned."""
        flat = _channels_to_front(x)
        lo = self._logits_cdf(flat - 0.5)
        up = self._logits_cdf(flat + 0.5)
        sign = -torch.sign(lo + up).detach()
        lik = torch.abs(torch.sigmoid(sign * up) - torch.sigmoid(sign * lo))
        return _channels_to_back(lik, x.shape)

    @property
    def medians(self):
        """Per-channel medians, the quantization offsets; shape (C,)."""
        return self.quantiles[:, 0, 1].detach()

    def quantize(self, x):
        """Median-centered rounding ('dequantize' semantics)."""
        medians = self.medians
        return torch.round(x - medians) + medians
