"""Density helpers for the entropy models (counterpart of nic_tpu/ops/stats.py)."""

import math

import torch

LOG2PI = math.log(2.0 * math.pi)


def log_normal_pdf(sample, mean, logvar):
    """Elementwise Normal log-density of ``sample`` under N(mean, exp(logvar))."""
    return -0.5 * ((sample - mean) ** 2 * torch.exp(-logvar) + logvar + LOG2PI)


def gaussian_standardized_cumulative(x):
    """Standard normal CDF via erfc for left-tail precision."""
    return 0.5 * torch.special.erfc(-(2 ** -0.5) * x)


def standardized_quantile(p: float) -> float:
    """Inverse standard-normal CDF of a Python float (a host-side helper):
    sizes the conditional model's coded supports from their tail mass."""
    from statistics import NormalDist

    return NormalDist().inv_cdf(p)


def box_convolved_gaussian_likelihood(inputs, mu, sigma):
    """Likelihood of ``inputs`` under N(mu, sigma^2) * U(-0.5, 0.5).

    Equals CDF(inputs - mu + .5) - CDF(inputs - mu - .5), evaluated in the
    left tail of the standardized cumulative where differences of small
    numbers keep their precision.
    """
    values = torch.abs(inputs - mu)
    upper = gaussian_standardized_cumulative((0.5 - values) / sigma)
    lower = gaussian_standardized_cumulative((-0.5 - values) / sigma)
    return upper - lower
