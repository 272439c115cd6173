"""Mean-scale hyperprior model, MBT2018 (counterpart of nic_tpu/models/mbt2018.py).

    p(z_tilde) = deep factorized prior
    p(y_tilde | z_tilde) = N(mu, sigma^2) * U(-.5, .5),  (mu, sigma) = h_s(z_tilde)
    p(x | y_tilde) = N(g_s(y_tilde), .)

The sub-passes are exposed one by one because the inference engine builds
its own computation over the latents. All tensors are NHWC. The transforms
compute in ``compute_dtype`` (float32 or bfloat16) and return float32; the
parameters, the z prior, the Gaussian conditional and the rate math stay
float32. ``forward`` is the training pass (uniform noise on z and y, no
crop) or the evaluation pass (rounding); ``rd_loss`` and ``aux_loss`` are
the two training objectives.
"""

import math
from typing import Dict, Optional, Tuple

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
    """The base hyperprior model: g_a, g_s, h_a, h_s and the z prior.

    ``upsample_impl`` ("transpose", "phases", "subpixel") is the form of
    g_s's and h_s's up-convs; ``quant`` (None, "int8", "int8_all") makes
    g_s's three N -> N up-convs and h_s's two up-convs W8A8
    (ops/int8conv.py), for frozen-weight inference only. ``clone`` gives
    another form sharing the parameters."""

    def __init__(self, num_filters: int = 192, compute_dtype: torch.dtype = torch.float32,
                 upsample_impl: str = "transpose", quant: Optional[str] = None):
        super().__init__()
        n = num_filters
        dt = compute_dtype
        self.num_filters = n
        self.compute_dtype = dt
        self.upsample_impl = upsample_impl
        self.quant = quant
        self.analysis = AnalysisTransform(n, dtype=dt)
        self.synthesis = SynthesisTransform(n, dtype=dt, upsample_impl=upsample_impl,
                                            quant=quant)
        self.hyper_analysis = HyperAnalysisTransform(n, dtype=dt)
        self.hyper_synthesis = MBT2018HyperSynthesisTransform(
            n, num_output_filters=2 * n, dtype=dt, upsample_impl=upsample_impl,
            quant=quant)
        self.entropy_bottleneck = FactorizedEntropyModel(n)
        self.conditional = GaussianConditional()

    def clone(self, **changes) -> "MeanScaleHyperprior":
        """This model with some of ``upsample_impl``, ``quant`` and
        ``compute_dtype`` changed (nic_tpu's ``model.clone(quant=...)``): its
        parameters and buffers are this model's own tensors, not copies."""
        kwargs = dict(num_filters=self.num_filters, compute_dtype=self.compute_dtype,
                      upsample_impl=self.upsample_impl, quant=self.quant)
        kwargs.update(changes)
        with torch.device("meta"):
            twin = MeanScaleHyperprior(**kwargs)
        twin.load_state_dict(self.state_dict(keep_vars=True), assign=True)
        for key, buf in self.named_buffers():  # the non-persistent ones too
            module, _, name = key.rpartition(".")
            setattr(twin.get_submodule(module), name, buf)
        return twin.train(self.training)

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

    def synthesize_blocks(self, y_tilde, block_hw=None):
        """The reconstruction in 2x2-block space (N, H/2, W/2, 12): the pixels
        of ``synthesize`` modulo depth-to-space, optionally cropped to
        ``block_hw`` blocks."""
        xb = self.synthesis(y_tilde, block_space=True)
        if block_hw is not None:
            h, w = block_hw
            xb = xb[:, :h, :w, :]
        return xb

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

    def aux_loss(self):
        """The z prior's quantile loss; its gradient reaches the quantiles only."""
        return self.entropy_bottleneck.aux_loss()

    # -------------------------------------------------------------- forward

    def forward(self, x, training: bool = False,
                noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """The full pass over NHWC images; returns a dict of NHWC tensors
        under nic_tpu's keys.

        Training adds U(-.5, .5) noise to z and to y, ``noise = (z's, y's)``
        or drawn from ``generator`` (z's first), and crops nothing: the
        patch size is a multiple of 64. Evaluation rounds z around the
        medians and y around mu, and crops mu, sigma and x_tilde to the
        input's sizes."""
        noise_z, noise_y = noise if noise is not None else (None, None)
        y = self.analyze(x)
        z = self.hyper_analyze(y)
        z_tilde, z_lik = self.entropy_bottleneck(z, training, noise_z, generator)
        mu, sigma = self.hyper_synthesize(
            z_tilde, y_hw=None if training else (y.shape[1], y.shape[2]))
        y_tilde, y_lik = self.conditional(y, mu, sigma, training, noise_y, generator)
        x_tilde = self.synthesize(
            y_tilde, x_hw=None if training else (x.shape[1], x.shape[2]))
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


def distortion_loss(x, x_tilde, distortion: str = "mse"):
    """The distortion term and its metrics: "mse", 255^2 * MSE; "msssim",
    1 - MS-SSIM (patches >= 176 pixels). Returns (distortion, metrics)."""
    float_mse = torch.mean(torch.square(x - x_tilde))
    psnr = -10.0 * torch.log(float_mse) / math.log(10.0)
    train_mse = float_mse * (255.0 ** 2)
    metrics = dict(mse=train_mse, psnr=psnr)
    if distortion == "mse":
        return train_mse, metrics
    if distortion == "msssim":
        from nic_tpu_torch.evaluation.metrics import msssim

        ms = torch.mean(msssim(x_tilde, x, max_val=1.0))
        metrics["msssim"] = ms
        return 1.0 - ms, metrics
    raise ValueError(f"Unknown distortion {distortion!r}")


def rd_loss(outputs: Dict[str, torch.Tensor], x, lmbda: float, distortion: str = "mse"):
    """The rate-distortion training loss, lmbda * distortion + bpp, with bpp
    over the whole batch's pixels. Returns (loss, metrics) under nic_tpu's
    metric keys."""
    num_pixels = x.shape[0] * x.shape[1] * x.shape[2]
    y_bpp = -torch.sum(torch.log(outputs["y_likelihoods"])) / (LN2 * num_pixels)
    z_bpp = -torch.sum(torch.log(outputs["z_likelihoods"])) / (LN2 * num_pixels)
    train_bpp = y_bpp + z_bpp
    dist, dist_metrics = distortion_loss(x, outputs["x_tilde"], distortion)
    loss = lmbda * dist + train_bpp
    return loss, dict(loss=loss, bpp=train_bpp, y_bpp=y_bpp, z_bpp=z_bpp, **dist_metrics)


def eval_bpp(outputs: Dict[str, torch.Tensor], num_pixels_per_image: int):
    """Per-image estimated (bpp, y_bpp, z_bpp)."""
    dims = (1, 2, 3)
    y_bpp = -torch.sum(torch.log(outputs["y_likelihoods"]), dim=dims) / (
        LN2 * num_pixels_per_image)
    z_bpp = -torch.sum(torch.log(outputs["z_likelihoods"]), dim=dims) / (
        LN2 * num_pixels_per_image)
    return y_bpp + z_bpp, y_bpp, z_bpp
