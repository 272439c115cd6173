"""Conditional Gaussian entropy model (counterpart of nic_tpu/models/conditional.py).

p(y|z) = N(mu, sigma^2) convolved with U(-0.5, 0.5); sigma is bounded below
by the smallest entry of the scale table. Stateless.
"""

from dataclasses import dataclass, field

import numpy as np
import torch

from nic_tpu_torch import config
from nic_tpu_torch.ops.bounds import lower_bound
from nic_tpu_torch.ops.stats import box_convolved_gaussian_likelihood


@dataclass(frozen=True)
class GaussianConditional:
    """Mean/scale conditional entropy model with a scale table."""

    scale_table: np.ndarray = field(default_factory=config.scale_table)
    likelihood_bound: float = config.LIKELIHOOD_LOWER_BOUND

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

    def quantize(self, y, mu):
        """Mean-centered rounding: round(y - mu) + mu."""
        return torch.round(y - mu) + mu
