"""Conditional Gaussian entropy model (counterpart of nic_tpu/models/conditional.py).

p(y|z) = N(mu, sigma^2) convolved with U(-0.5, 0.5); sigma is bounded below
by the smallest entry of the scale table, and discretized by the table's
index for entropy coding. Stateless.
"""

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from nic_tpu_torch import config
from nic_tpu_torch.ops.bounds import lower_bound
from nic_tpu_torch.ops.quantize import uniform_noise
from nic_tpu_torch.ops.stats import (box_convolved_gaussian_likelihood,
                                     standardized_quantile)


@dataclass(frozen=True)
class GaussianConditional:
    """Mean/scale conditional entropy model with a scale table."""

    scale_table: np.ndarray = field(default_factory=config.scale_table)
    likelihood_bound: float = config.LIKELIHOOD_LOWER_BOUND
    tail_mass: float = config.CONDITIONAL_TAIL_MASS

    @property
    def scale_min(self) -> float:
        return float(self.scale_table[0])

    def bound_scale(self, sigma):
        """Lower-bound sigma at the smallest table scale."""
        return lower_bound(sigma, self.scale_min)

    def likelihood(self, y, mu, sigma):
        """p(y | mu, sigma) under the box-convolved Gaussian, lower-bounded."""
        lik = box_convolved_gaussian_likelihood(y, mu, self.bound_scale(sigma))
        return lower_bound(lik, self.likelihood_bound)

    def __call__(self, y, mu, sigma, training: bool,
                 noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
        """(y_tilde, likelihoods): U(-.5, .5) noise in training (``noise``, of
        y's shape, or drawn from ``generator``), mean-centered rounding in
        evaluation."""
        y_tilde = uniform_noise(y, generator, noise) if training else self.quantize(y, mu)
        return y_tilde, self.likelihood(y_tilde, mu, sigma)

    def quantize(self, y, mu):
        """Mean-centered rounding: round(y - mu) + mu."""
        return torch.round(y - mu) + mu

    def symbols(self, y, mu):
        """Integer symbols round(y - mu) for entropy coding."""
        return torch.round(y - mu).to(torch.int32)

    def dequantize_symbols(self, symbols, mu):
        return symbols.float() + mu

    def scale_indexes(self, sigma):
        """Index of the smallest table scale >= sigma, clamped to the table
        (tfc GaussianConditional's bucketization)."""
        table = torch.as_tensor(self.scale_table[:-1], dtype=torch.float32,
                                device=sigma.device)
        return torch.sum(sigma[..., None] > table, dim=-1).to(torch.int32)

    # ------------------------------------------------------------ pmf export

    def support_halfwidths(self) -> np.ndarray:
        """Per-level integer half-width of the coded support (host)."""
        multiplier = -standardized_quantile(self.tail_mass / 2.0)
        return np.ceil(np.asarray(self.scale_table) * multiplier).astype(np.int64)

    def pmfs_for_coding(self):
        """PMF rows for each scale level over [-w_i, w_i] (host, numpy), as
        (pmf, offsets, lengths, tail) like the factorized prior's tables."""
        widths = self.support_halfwidths()
        max_len = int(2 * widths.max() + 1)
        n = len(self.scale_table)
        pmf = np.zeros((n, max_len), np.float64)
        offsets = -widths
        lengths = 2 * widths + 1
        for i, (s, w) in enumerate(zip(self.scale_table, widths)):
            grid = np.arange(-w, w + 1, dtype=np.float64)
            upper = _std_cdf((grid + 0.5) / s)
            lower_ = _std_cdf((grid - 0.5) / s)
            pmf[i, : 2 * w + 1] = upper - lower_
        tail = np.maximum(1.0 - pmf.sum(axis=1), 0.0)
        return pmf, offsets.astype(np.int32), lengths.astype(np.int32), tail


def _std_cdf(x):
    from scipy.special import erfc

    return 0.5 * erfc(-(2 ** -0.5) * x)
