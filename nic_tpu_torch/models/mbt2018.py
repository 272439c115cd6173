"""Mean-scale hyperprior model, MBT2018 (counterpart of nic_tpu/models/mbt2018.py).

    p(z_tilde) = deep factorized prior
    p(y_tilde | z_tilde) = N(mu, sigma^2) * U(-.5, .5),  (mu, sigma) = h_s(z_tilde)
    p(x | y_tilde) = N(g_s(y_tilde), .)

The sub-passes are exposed one by one because the inference engine builds
its own computation over the latents. All tensors are NHWC. The transforms
compute in ``compute_dtype`` (float32 or bfloat16) and return float32; the
parameters, the z prior, the Gaussian conditional and the rate math stay
float32. The evaluation forward and the coding tables are ported (training
is later work).
"""

from typing import Dict

import torch
from torch import nn

from nic_tpu_torch.models.conditional import GaussianConditional
from nic_tpu_torch.models.factorized_prior import FactorizedEntropyModel
from nic_tpu_torch.models.transforms import (
    AnalysisTransform,
    HyperAnalysisTransform,
    MBT2018HyperSynthesisTransform,
    SynthesisTransform,
)
from nic_tpu_torch.ops.bounds import lower_bound

LN2 = 0.6931471805599453


class MeanScaleHyperprior(nn.Module):
    """The base hyperprior model: g_a, g_s, h_a, h_s and the z prior."""

    def __init__(self, num_filters: int = 192, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        n = num_filters
        dt = compute_dtype
        self.num_filters = n
        self.compute_dtype = dt
        self.analysis = AnalysisTransform(n, dtype=dt)
        self.synthesis = SynthesisTransform(n, dtype=dt)
        self.hyper_analysis = HyperAnalysisTransform(n, dtype=dt)
        self.hyper_synthesis = MBT2018HyperSynthesisTransform(
            n, num_output_filters=2 * n, dtype=dt)
        self.entropy_bottleneck = FactorizedEntropyModel(n)
        self.conditional = GaussianConditional()

    # ----------------------------------------------------------- sub-passes

    def analyze(self, x):
        return self.analysis(x)

    def hyper_analyze(self, y):
        return self.hyper_analysis(y)

    def hyper_synthesize(self, z_tilde, y_hw=None):
        """(mu, sigma) from z_tilde; optionally cropped to y's spatial dims."""
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

    def z_likelihood(self, z_tilde):
        """Lower-bounded factorized likelihood of a (possibly relaxed) z."""
        lik = self.entropy_bottleneck.likelihood(z_tilde)
        return lower_bound(lik, self.entropy_bottleneck.likelihood_bound)

    def y_likelihood(self, y_tilde, mu, sigma):
        return self.conditional.likelihood(y_tilde, mu, sigma)

    def quantize_z(self, z):
        return self.entropy_bottleneck.quantize(z)

    def medians(self):
        return self.entropy_bottleneck.medians

    def pmf_for_coding(self, max_length: int = 256, grid: str = "median"):
        return self.entropy_bottleneck.pmf_for_coding(max_length, grid=grid)

    # -------------------------------------------------------------- forward

    def forward(self, x) -> Dict[str, torch.Tensor]:
        """Evaluation forward pass: median/mean-centered rounding of the
        amortized latents. Returns a dict of NHWC tensors."""
        y = self.analyze(x)
        z = self.hyper_analyze(y)
        z_tilde = self.quantize_z(z)
        z_lik = self.z_likelihood(z_tilde)
        mu, sigma = self.hyper_synthesize(z_tilde, y_hw=(y.shape[1], y.shape[2]))
        y_tilde = self.conditional.quantize(y, mu)
        y_lik = self.y_likelihood(y_tilde, mu, sigma)
        x_tilde = self.synthesize(y_tilde, x_hw=(x.shape[1], x.shape[2]))
        return dict(
            y=y,
            z=z,
            z_tilde=z_tilde,
            z_likelihoods=z_lik,
            mu=mu,
            sigma=sigma,
            y_tilde=y_tilde,
            y_likelihoods=y_lik,
            x_tilde=x_tilde,
        )

