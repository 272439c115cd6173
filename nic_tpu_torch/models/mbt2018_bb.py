"""Bits-back variant of the mean-scale hyperprior, "mbt2018_bb"
(counterpart of nic_tpu/models/mbt2018_bb.py).

The same generative model as MBT2018, with a Gaussian inference posterior
over the hyper-latent, q(z_tilde | y) = N(h_a(y)), sampled by
reparameterization, and the learned factorized prior evaluated as a
continuous pdf. The net rate subtracts the bits-back term E[-log q(z_tilde)].
h_a and h_s both emit 2N channels: (mean, log variance) and (mu, log sigma).

The sub-passes are what the bits-back engine (``infer/bb.py``) and codec
(``coding/bb_codec.py``) build on. ``forward`` is the training pass
(sigma bounded by sqrt(VARIANCE_UPPER_BOUND_BB_TRAIN), uniform noise on y,
no crop) or the evaluation pass (rounding); both take their
reparameterization draw as a tensor or from a generator. ``bb_rd_loss`` is
the training objective. The transforms compute in ``compute_dtype`` and
return float32; the prior and the rate math stay float32.
"""

from typing import Dict, Optional

import torch
from torch import nn

from nic_tpu_torch.config import LIKELIHOOD_LOWER_BOUND, VARIANCE_UPPER_BOUND_BB_TRAIN
from nic_tpu_torch.models.conditional import GaussianConditional
from nic_tpu_torch.models.factorized_prior import FactorizedEntropyModel
from nic_tpu_torch.models.transforms import (
    AnalysisTransform,
    HyperAnalysisTransform,
    MBT2018HyperSynthesisTransform,
    SynthesisTransform,
)
from nic_tpu_torch.models.mbt2018 import LN2, distortion_loss
from nic_tpu_torch.ops.bounds import lower_bound, upper_bound
from nic_tpu_torch.ops.stats import log_normal_pdf


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
        gradient reaches z_tilde and the prior's parameters (reverse mode
        through the pdf's forward-mode derivative)."""
        return lower_bound(self.hyper_prior.pdf(z_tilde), LIKELIHOOD_LOWER_BOUND)

    def hyper_synthesize(self, z_tilde, y_hw=None, training: bool = False):
        """(mu, sigma = exp(log sigma)) from z_tilde, optionally cropped to
        y's spatial dims; in training sigma is bounded above by
        sqrt(VARIANCE_UPPER_BOUND_BB_TRAIN)."""
        mu, log_sigma = torch.chunk(self.hyper_synthesis(z_tilde), 2, dim=-1)
        sigma = torch.exp(log_sigma)
        if training:
            sigma = upper_bound(sigma, VARIANCE_UPPER_BOUND_BB_TRAIN ** 0.5)
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

    def forward(self, x, eps: Optional[torch.Tensor] = None, training: bool = False,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """z_tilde = eps * exp(z_logvar / 2) + z_mean, with ``eps`` a
        standard-normal tensor of z_mean's shape or drawn from ``generator``.
        Training bounds sigma, adds U(-.5, .5) noise to y (``noise``, of y's
        shape, or drawn from ``generator`` after eps) and crops nothing;
        evaluation rounds y around mu and crops to the input's sizes.
        Returns a dict of NHWC tensors under nic_tpu's keys."""
        y = self.analyze(x)
        z_mean, z_logvar = self.hyper_posterior(y)
        if eps is None:
            if generator is None:
                raise ValueError("the bits-back forward needs eps or a generator")
            eps = torch.randn(z_mean.shape, generator=generator, device=z_mean.device)
        z_tilde = eps * torch.exp(z_logvar * 0.5) + z_mean
        y_hw = None if training else (y.shape[1], y.shape[2])
        mu, sigma = self.hyper_synthesize(z_tilde, y_hw=y_hw, training=training)
        y_tilde, y_lik = self.conditional(y, mu, sigma, training, noise, generator)
        x_hw = None if training else (x.shape[1], x.shape[2])
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
            y_likelihoods=y_lik,
            x_tilde=self.synthesize(y_tilde, x_hw=x_hw),
        )


def bb_rd_loss(outputs: Dict[str, torch.Tensor], x, lmbda: float,
               distortion: str = "mse"):
    """The bits-back training loss: lmbda * distortion + the net rate,
    y_bpp + z_bpp - bpp_back, over the whole batch's pixels. Returns (loss,
    metrics) under nic_tpu's metric keys."""
    num_pixels = x.shape[0] * x.shape[1] * x.shape[2]
    bpp_back = -torch.sum(outputs["log_q_z_tilde"]) / (LN2 * num_pixels)
    y_bpp = -torch.sum(torch.log(outputs["y_likelihoods"])) / (LN2 * num_pixels)
    z_bpp = -torch.sum(torch.log(outputs["z_likelihoods"])) / (LN2 * num_pixels)
    train_bpp = y_bpp + z_bpp - bpp_back
    dist, dist_metrics = distortion_loss(x, outputs["x_tilde"], distortion)
    loss = lmbda * dist + train_bpp
    return loss, dict(loss=loss, bpp=train_bpp, y_bpp=y_bpp, z_bpp=z_bpp,
                      bpp_back=bpp_back, **dist_metrics)
