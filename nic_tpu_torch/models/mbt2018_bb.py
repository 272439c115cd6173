"""Bits-back variant of the mean-scale hyperprior, "mbt2018_bb"
(counterpart of nic_tpu/models/mbt2018_bb.py).

The same generative model as MBT2018, with a Gaussian inference posterior
over the hyper-latent, q(z_tilde | y) = N(h_a(y)), sampled by
reparameterization, and the learned factorized prior evaluated as a
continuous pdf. The net rate subtracts the bits-back term E[-log q(z_tilde)].
h_a and h_s both emit 2N channels: (mean, log variance) and (mu, log sigma).

The sub-passes are what the bits-back engine (``infer/bb.py``) and codec
(``coding/bb_codec.py``) build on; ``forward`` is the evaluation pass and
takes its reparameterization noise as a tensor. The transforms compute in
``compute_dtype`` and return float32; the prior and the rate math stay
float32. The training half (``training=True``) is later work.
"""

from typing import Dict

import torch
from torch import nn

from nic_tpu_torch.config import LIKELIHOOD_LOWER_BOUND
from nic_tpu_torch.models.conditional import GaussianConditional
from nic_tpu_torch.models.factorized_prior import FactorizedEntropyModel
from nic_tpu_torch.models.transforms import (
    AnalysisTransform,
    HyperAnalysisTransform,
    MBT2018HyperSynthesisTransform,
    SynthesisTransform,
)
from nic_tpu_torch.ops.bounds import lower_bound
from nic_tpu_torch.ops.stats import log_normal_pdf

_TRAINING = ("training the bits-back model is not ported yet (ROADMAP.md §1 "
             "item 5)")


class BitsBackHyperprior(nn.Module):
    """Hyperprior with a Gaussian hyper-posterior for bits-back coding."""

    def __init__(self, num_filters: int = 192, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        n = num_filters
        dt = compute_dtype
        self.num_filters = n
        self.compute_dtype = dt
        self.analysis = AnalysisTransform(n, dtype=dt)
        self.synthesis = SynthesisTransform(n, dtype=dt)
        self.hyper_analysis = HyperAnalysisTransform(n, num_output_filters=2 * n, dtype=dt)
        self.hyper_synthesis = MBT2018HyperSynthesisTransform(
            n, num_output_filters=2 * n, dtype=dt)
        self.hyper_prior = FactorizedEntropyModel(n, dims=(3, 3, 3))
        self.conditional = GaussianConditional()

    # ----------------------------------------------------------- sub-passes

    def analyze(self, x):
        return self.analysis(x)

    def hyper_posterior(self, y):
        """(z_mean, z_logvar) = split(h_a(y))."""
        return tuple(torch.chunk(self.hyper_analysis(y), 2, dim=-1))

    def hyper_prior_pdf(self, z_tilde):
        """The prior's continuous density at z_tilde, lower-bounded; its
        gradient reaches z_tilde (reverse mode through the pdf's
        forward-mode derivative)."""
        return lower_bound(self.hyper_prior.pdf(z_tilde), LIKELIHOOD_LOWER_BOUND)

    def hyper_synthesize(self, z_tilde, y_hw=None, training: bool = False):
        """(mu, sigma = exp(log sigma)) from z_tilde, optionally cropped to
        y's spatial dims."""
        if training:
            raise NotImplementedError(_TRAINING)
        mu, log_sigma = torch.chunk(self.hyper_synthesis(z_tilde), 2, dim=-1)
        sigma = torch.exp(log_sigma)
        if y_hw is not None:
            h, w = y_hw
            mu = mu[:, :h, :w, :]
            sigma = sigma[:, :h, :w, :]
        return mu, sigma

    def synthesize(self, y_tilde, x_hw=None):
        x_tilde = self.synthesis(y_tilde)
        if x_hw is not None:
            h, w = x_hw
            x_tilde = x_tilde[:, :h, :w, :]
        return x_tilde

    def y_likelihood(self, y_tilde, mu, sigma):
        return self.conditional.likelihood(y_tilde, mu, sigma)

    # -------------------------------------------------------------- forward

    def forward(self, x, eps, training: bool = False) -> Dict[str, torch.Tensor]:
        """Evaluation pass: z_tilde = eps * exp(z_logvar / 2) + z_mean, with
        ``eps`` a standard-normal tensor of z_mean's shape, and mean-centered
        rounding of y. Returns a dict of NHWC tensors under nic_tpu's keys."""
        if training:
            raise NotImplementedError(_TRAINING)
        y = self.analyze(x)
        z_mean, z_logvar = self.hyper_posterior(y)
        z_tilde = eps * torch.exp(z_logvar * 0.5) + z_mean
        mu, sigma = self.hyper_synthesize(z_tilde, y_hw=(y.shape[1], y.shape[2]))
        y_tilde = self.conditional.quantize(y, mu)
        return dict(
            y=y,
            z_mean=z_mean,
            z_logvar=z_logvar,
            z_tilde=z_tilde,
            log_q_z_tilde=log_normal_pdf(z_tilde, z_mean, z_logvar),
            z_likelihoods=self.hyper_prior_pdf(z_tilde),
            mu=mu,
            sigma=sigma,
            y_tilde=y_tilde,
            y_likelihoods=self.y_likelihood(y_tilde, mu, sigma),
            x_tilde=self.synthesize(y_tilde, x_hw=(x.shape[1], x.shape[2])),
        )
