"""Deep factorized prior / entropy bottleneck for the hyper-latent z
(counterpart of nic_tpu/models/factorized_prior.py: the CDF network, the
likelihood, the training and evaluation forward, the quantile loss, the
medians and quantization, and the coding half: cdf, pdf, inverse_cdf, the
PMF tables for the rANS coder and pmf_on_grid).

The density: a monotone map built from K+1 stages
  u <- softplus(H_k) @ u + b_k ;  u <- u + tanh(a_k) * tanh(u)  (k < K)
whose sigmoid is the CDF. Each channel has its own parameters, stored in
nic_tpu's (C, ., .) shapes; the batch rides along the last axis of a
(C, d, N) tensor so every stage is one batched matmul.
"""

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from nic_tpu_torch.config import FACTORIZED_TAIL_MASS, LIKELIHOOD_LOWER_BOUND
from nic_tpu_torch.ops.bounds import lower_bound
from nic_tpu_torch.ops.quantize import uniform_noise


def _channels_to_front(x):
    """(..., C) -> (C, 1, N)."""
    return x.movedim(-1, 0).reshape(x.shape[-1], 1, -1)


def _channels_to_back(flat, shape):
    return flat.reshape((shape[-1],) + tuple(shape[:-1])).movedim(0, -1)


class FactorizedEntropyModel(nn.Module):
    """Learned factorized prior with learned quantiles (tail, median, tail)."""

    def __init__(self, channels: int, dims: Tuple[int, ...] = (3, 3, 3),
                 init_scale: float = 10.0,
                 likelihood_bound: float = LIKELIHOOD_LOWER_BOUND,
                 tail_mass: float = FACTORIZED_TAIL_MASS):
        super().__init__()
        self.channels = channels
        self.dims = tuple(dims)
        self.init_scale = init_scale
        self.likelihood_bound = likelihood_bound
        self.tail_mass = tail_mass
        filters = (1,) + self.dims + (1,)
        for i in range(len(self.dims) + 1):
            self.register_parameter(f"matrix_{i}", nn.Parameter(
                torch.empty(channels, filters[i + 1], filters[i])))
            self.register_parameter(f"bias_{i}", nn.Parameter(
                torch.empty(channels, filters[i + 1], 1)))
            if i < len(self.dims):
                self.register_parameter(f"factor_{i}", nn.Parameter(
                    torch.empty(channels, filters[i + 1], 1)))
        self.quantiles = nn.Parameter(torch.empty(channels, 1, 3))
        # The quantile loss's targets, the logits of (tail/2, 1/2, 1 - tail/2):
        # a buffer, so a step on the card copies nothing from the host.
        target = math.log(2.0 / tail_mass - 1.0)
        self.register_buffer("quantile_targets", torch.tensor([-target, 0.0, target]),
                             persistent=False)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """nic_tpu's initial values: constant matrices of width init_scale,
        biases U(-0.5, 0.5) (drawn from ``generator``), zero factors and the
        quantiles (-init_scale, 0, init_scale)."""
        filters = (1,) + self.dims + (1,)
        scale = self.init_scale ** (1.0 / (len(self.dims) + 1))
        for i in range(len(self.dims) + 1):
            getattr(self, f"matrix_{i}").fill_(
                math.log(math.expm1(1.0 / scale / filters[i + 1])))
            nn.init.uniform_(getattr(self, f"bias_{i}"), -0.5, 0.5, generator=generator)
            if i < len(self.dims):
                getattr(self, f"factor_{i}").zero_()
        q = torch.tensor([-self.init_scale, 0.0, self.init_scale])
        self.quantiles.copy_(q.expand_as(self.quantiles))

    def _logits_cdf(self, u, stop_gradient: bool = False):
        """CDF logits for u of shape (C, d, N); ``stop_gradient`` keeps the
        density's parameters out of the graph."""

        def param(name):
            v = getattr(self, name)
            return v.detach() if stop_gradient else v

        logits = u
        k = len(self.dims)
        for i in range(k + 1):
            m = F.softplus(param(f"matrix_{i}"))
            logits = torch.matmul(m, logits) + param(f"bias_{i}")
            if i < k:
                f = torch.tanh(param(f"factor_{i}"))
                logits = logits + f * torch.tanh(logits)
        return logits

    def cdf(self, x, stop_gradient: bool = False):
        """Model CDF of channels-last x."""
        logits = self._logits_cdf(_channels_to_front(x), stop_gradient)
        return _channels_to_back(torch.sigmoid(logits), x.shape)

    def pdf(self, x, stop_gradient: bool = False):
        """Model PDF = d/dx CDF, by forward-mode autodiff as in nic_tpu.
        Reverse mode runs through it: its gradient reaches x and, unless
        ``stop_gradient``, the density's parameters."""
        return self.cdf_pdf(x, stop_gradient)[1]

    def cdf_pdf(self, x, stop_gradient: bool = False):
        """(CDF, PDF) in one forward-mode pass."""
        return torch.func.jvp(
            lambda v: self.cdf(v, stop_gradient), (x,), (torch.ones_like(x),)
        )

    def logpdf(self, x, pdf_lower_bound: float = 1e-10, stop_gradient: bool = False):
        """log PDF, the PDF lower-bounded before the log."""
        pdf = self.pdf(x, stop_gradient)
        if pdf_lower_bound:
            pdf = lower_bound(pdf, pdf_lower_bound)
        return torch.log(pdf)

    def likelihood(self, x, stop_gradient_density: bool = False):
        """P(x - .5 < X <= x + .5), channels-last: a sign-stabilized
        difference of sigmoids, both ends evaluated in whichever tail keeps
        the subtraction well-conditioned."""
        flat = _channels_to_front(x)
        lo = self._logits_cdf(flat - 0.5, stop_gradient_density)
        up = self._logits_cdf(flat + 0.5, stop_gradient_density)
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

    def forward(self, x, training: bool, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """(x_tilde, likelihoods), channels-last. Training adds U(-.5, .5)
        noise (``noise``, of x's shape, or drawn from ``generator``);
        evaluation rounds around the medians. The likelihoods are
        lower-bounded."""
        x_tilde = uniform_noise(x, generator, noise) if training else self.quantize(x)
        lik = self.likelihood(x_tilde)
        if self.likelihood_bound > 0:
            lik = lower_bound(lik, self.likelihood_bound)
        return x_tilde, lik

    def aux_loss(self):
        """Quantile loss: pins the learned quantiles to the density's
        (tail/2, 1/2, 1 - tail/2) points. The density's parameters are
        detached, so its gradient reaches ``quantiles`` only."""
        logits = self._logits_cdf(self.quantiles, stop_gradient=True)
        return torch.sum(torch.abs(logits - self.quantile_targets))

    # ------------------------------------------------------------- coding

    @torch.no_grad()
    def inverse_cdf(self, xi, doublings: int = 16, iterations: int = 60):
        """Bisection inverse of the CDF: a fixed number of bracket doublings,
        then a fixed number of bisections, as in nic_tpu."""

        def f(v):
            return self.cdf(v, stop_gradient=True) - xi

        left = torch.full_like(xi, -1.0)
        right = torch.full_like(xi, 1.0)
        for _ in range(doublings):
            left = torch.where(f(left) >= 0, left * 2.0, left)
            right = torch.where(f(right) <= 0, right * 2.0, right)
        for _ in range(iterations):
            mid = 0.5 * (left + right)
            fm = f(mid)
            left = torch.where(fm < 0, mid, left)
            right = torch.where(fm > 0, mid, right)
        return 0.5 * (left + right)

    @torch.no_grad()
    def pmf_for_coding(self, max_length: int = 256, grid: str = "median"):
        """Per-channel PMFs over grids covering the learned support, for the
        quantized CDF tables (``coding/tables.py``).

        grid='median': points median + k, the grid of ``quantize`` (symbols
        round(x - median)); grid='integer': plain integers, the grid of
        plainly rounded latents (what SGA transmits).

        Returns (pmf (C, max_length), offsets (C,), lengths (C,), tail (C,)).
        """
        q = self.quantiles[:, 0, :]
        medians = q[:, 1]
        if grid == "median":
            minima = torch.clamp(torch.ceil(medians - q[:, 0]).int(), min=0)
            maxima = torch.clamp(torch.ceil(q[:, 2] - medians).int(), min=0)
            lengths = torch.clamp(minima + maxima + 1, max=max_length)
            offsets = -minima
            base = medians[:, None]
        elif grid == "integer":
            lo = torch.floor(q[:, 0]).int()
            hi = torch.ceil(q[:, 2]).int()
            lengths = torch.clamp(hi - lo + 1, max=max_length)
            offsets = lo
            base = torch.zeros_like(medians)[:, None]
        else:
            raise ValueError(f"Unknown grid {grid!r}")
        idx = torch.arange(max_length, device=q.device)[None, :]
        points = base + offsets[:, None].float() + idx.float()
        pmf = self.likelihood(points.T, stop_gradient_density=True).T
        pmf = torch.where(idx < lengths[:, None], pmf, torch.zeros_like(pmf))
        tail = torch.clamp(1.0 - torch.sum(pmf, dim=1), min=0.0)
        return pmf, offsets, lengths, tail

    @torch.no_grad()
    def pmf_on_grid(self, lo: float, hi: float, delta: float):
        """Per-channel bin probabilities over a uniform grid: bin k covers
        [lo + k*delta, lo + (k+1)*delta), the tail mass outside [lo, hi]
        folded into the edge bins. Returns (C, B), B = round((hi-lo)/delta).
        """
        num_bins = int(round((hi - lo) / delta))
        device = self.quantiles.device
        edges = lo + delta * torch.arange(1, num_bins, device=device)
        cdf = self.cdf(edges[:, None].expand(-1, self.channels), stop_gradient=True)
        ones = torch.ones((1, self.channels), device=device)
        cdf = torch.cat([torch.zeros_like(ones), cdf, ones], dim=0)
        return torch.diff(cdf, dim=0).T
