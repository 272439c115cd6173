"""Bits-back iterative inference: bb_sga, bb_no_sga and bb_plain
(counterpart of nic_tpu/infer/bb.py).

Phase 1 (bb_sga only) optimizes (y, z_mean, z_logvar) jointly on the RD
objective, with the SGA relaxation on y and a reparameterized sample of z.
y is then frozen as y* = round(y) and the posterior re-initialized from
h_a(y*); phase 2 optimizes the posterior on the rate alone. bb_no_sga runs
phase 2 only, bb_plain neither: its posterior is the amortized h_a(y*).
The final evaluation draws one fresh posterior sample.

The loops run on the device as the engine's do (``infer/engine.py``): the
temperature and Adam's step size come from the step number on the host,
each step's loss goes into a preallocated device tensor, and there is no
host sync per step. Noise comes from a ``torch.Generator`` on the device:
seeded with ``seed`` for phase 1, re-seeded with ``seed`` before phase 2
(as nic_tpu re-seeds), and seeded with ``seed + 1`` for the evaluation
sample. Phase 1 draws each step's Gumbel pair for y, then the normal draw
for z. A caller may instead pass ``noise_fn(step, name, shape)``: ``step``
is ``(1, it)`` in phase 1 (names "gumbel", "eps"), ``(2, it)`` in phase 2
("eps") and None for the evaluation sample ("eps"); tests use it to feed
JAX's draws.
"""

from dataclasses import dataclass, replace
from typing import Callable, Dict, Optional

import numpy as np
import torch

from nic_tpu_torch import config
from nic_tpu_torch.infer.adam import adam_init, adam_update
from nic_tpu_torch.infer.engine import (
    MSSSIM_MIN_SIDE,
    device_timer,
    distortion_metrics,
    to_numpy,
)
from nic_tpu_torch.models.mbt2018 import LN2
from nic_tpu_torch.models.mbt2018_bb import BitsBackHyperprior
from nic_tpu_torch.ops.quantize import draw_gumbel, sga_relax
from nic_tpu_torch.ops.schedules import annealed_temperature
from nic_tpu_torch.ops.stats import log_normal_pdf

NoiseFn = Callable[[Optional[tuple], str, tuple], torch.Tensor]


@dataclass(frozen=True)
class BBMethodSpec:
    name: str
    rd_iterations: int = 2000       # phase 1
    rd_lr: float = 0.005
    rate_iterations: int = 2000     # phase 2
    rate_lr: float = 0.003
    annealing_scheme: str = "exp0"
    annealing_rate: float = 1e-3
    t0: int = 700
    temperature_ub: float = 0.5

    def replace(self, **kw) -> "BBMethodSpec":
        return replace(self, **kw)


BB_SGA = BBMethodSpec(name="bb_sga")
BB_NO_SGA = BBMethodSpec(name="bb_no_sga", rd_iterations=0, rate_iterations=1000,
                         rate_lr=0.005)
BB_PLAIN = BBMethodSpec(name="bb_plain", rd_iterations=0, rate_iterations=0)
BB_METHODS = {m.name: m for m in (BB_SGA, BB_NO_SGA, BB_PLAIN)}


def _bb_rate_terms(model: BitsBackHyperprior, y_tilde, z_mean, z_logvar, eps,
                   num_pixels: int):
    """Sample z_tilde = eps * exp(z_logvar / 2) + z_mean and compute the
    per-image (y_bpp, z_bpp, bpp_back, mu, sigma)."""
    z_tilde = eps * torch.exp(z_logvar * 0.5) + z_mean
    log_q = log_normal_pdf(z_tilde, z_mean, z_logvar)
    z_lik = model.hyper_prior_pdf(z_tilde)
    mu, sigma = model.hyper_synthesize(z_tilde, (y_tilde.shape[1], y_tilde.shape[2]))
    y_lik = model.y_likelihood(y_tilde, mu, sigma)
    axes = (1, 2, 3)
    bpp_back = -torch.sum(log_q, dim=axes) / (LN2 * num_pixels)
    y_bpp = -torch.sum(torch.log(y_lik), dim=axes) / (LN2 * num_pixels)
    z_bpp = -torch.sum(torch.log(z_lik), dim=axes) / (LN2 * num_pixels)
    return y_bpp, z_bpp, bpp_back, mu, sigma


def _rd_loss(model, y, z_mean, z_logvar, x, lmbda: float, temperature, gumbel, eps):
    """Phase 1's objective: lambda * 255^2 MSE + mean net bpp, with SGA on
    y (``gumbel`` of shape y.shape + (2,))."""
    y_tilde = sga_relax(y, temperature, gumbel=gumbel)
    x_tilde = model.synthesize(y_tilde, (x.shape[1], x.shape[2]))
    y_bpp, z_bpp, bpp_back, _, _ = _bb_rate_terms(
        model, y_tilde, z_mean, z_logvar, eps, x.shape[1] * x.shape[2])
    train_bpp = torch.mean(y_bpp + z_bpp - bpp_back)
    mse = torch.mean(torch.square(x - x_tilde)) * (255.0 ** 2)
    return lmbda * mse + train_bpp if lmbda > 0 else train_bpp


def _rate_loss(model, y_tilde, z_mean, z_logvar, eps, num_pixels: int):
    """Phase 2's objective: the mean net bpp given frozen y_tilde."""
    y_bpp, z_bpp, bpp_back, _, _ = _bb_rate_terms(
        model, y_tilde, z_mean, z_logvar, eps, num_pixels)
    return torch.mean(y_bpp + z_bpp - bpp_back)


@torch.no_grad()
def _bb_eval(model, x, y_tilde, z_mean, z_logvar, eps, compute_msssim: bool):
    """Final evaluation with one posterior sample: estimated rates and the
    distortion of the reconstruction rounded to 8 bits."""
    y_bpp, z_bpp, bpp_back, _, _ = _bb_rate_terms(
        model, y_tilde, z_mean, z_logvar, eps, x.shape[1] * x.shape[2])
    x_tilde = model.synthesize(y_tilde, (x.shape[1], x.shape[2]))
    return dict(
        **distortion_metrics(x, x_tilde, compute_msssim),
        est_bpp=y_bpp + z_bpp - bpp_back,
        est_y_bpp=y_bpp,
        est_z_bpp=z_bpp,
        est_bpp_back=bpp_back,
        x_tilde=x_tilde,
    )


class BBLatentOptimizer:
    """Binds a BitsBackHyperprior to a device; runs bb_sga, bb_no_sga or
    bb_plain over an image batch.

    The model is moved to ``device`` (the card unless the caller asks for
    the CPU), put in eval mode and frozen. ``last_timing`` holds each
    phase's steps and loop time (``rd_steps``, ``rd_ms``, ``rate_steps``,
    ``rate_ms``; CUDA events on the card).
    """

    def __init__(self, model: BitsBackHyperprior, device="cuda"):
        config.set_fp32_precision()
        self.device = config.resolve_device(device)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.last_timing: Dict[str, float] = {}

    @torch.no_grad()
    def posterior(self, y_tilde):
        """The amortized posterior (z_mean, z_logvar) = split(h_a(y_tilde))."""
        return self.model.hyper_posterior(y_tilde)

    def optimize(self, x, lmbda: float, spec: BBMethodSpec = BB_SGA, seed: int = 0,
                 noise_fn: Optional[NoiseFn] = None) -> Dict[str, np.ndarray]:
        """Run ``spec``'s phases on one image batch. Returns the transmitted
        y* (``y``), the final posterior (``z_mean``, ``z_logvar``), each
        phase's per-step losses (``rd_losses``, ``rate_losses``) and the
        per-image evaluation metrics, under nic_tpu's keys."""
        model, dev = self.model, self.device
        x = torch.from_numpy(np.array(x, np.float32)).to(dev)
        generator = torch.Generator(device=dev)

        def draw(step, name, shape):
            if noise_fn is not None:
                return noise_fn(step, name, tuple(shape)).to(dev)
            if name == "gumbel":
                return draw_gumbel(shape, generator, dev)
            return torch.randn(shape, generator=generator, device=dev)

        with torch.no_grad():
            y = model.analyze(x)
        timing = dict(rd_steps=spec.rd_iterations, rd_ms=0.0,
                      rate_steps=spec.rate_iterations, rate_ms=0.0)
        rd_losses = torch.zeros(spec.rd_iterations, device=dev)
        if spec.rd_iterations > 0:
            generator.manual_seed(seed)
            state = [t.clone().requires_grad_(True)
                     for t in (y, *self.posterior(y))]
            adam = adam_init(state)
            stop = device_timer(dev)
            for it in range(spec.rd_iterations):
                temperature = annealed_temperature(
                    it, r=spec.annealing_rate, ub=spec.temperature_ub,
                    scheme=spec.annealing_scheme, t0=spec.t0)
                gumbel = draw((1, it), "gumbel", tuple(y.shape) + (2,))
                eps = draw((1, it), "eps", state[1].shape)
                loss = _rd_loss(model, *state, x, lmbda, temperature, gumbel, eps)
                grads = torch.autograd.grad(loss, state)
                adam = adam_update(state, grads, adam, spec.rd_lr)
                rd_losses[it] = loss.detach()
            timing["rd_ms"] = stop()
            y = state[0].detach()

        y_tilde = torch.round(y)
        z_mean, z_logvar = self.posterior(y_tilde)
        rate_losses = torch.zeros(spec.rate_iterations, device=dev)
        if spec.rate_iterations > 0:
            generator.manual_seed(seed)
            post = [t.clone().requires_grad_(True) for t in (z_mean, z_logvar)]
            adam = adam_init(post)
            num_pixels = x.shape[1] * x.shape[2]
            stop = device_timer(dev)
            for it in range(spec.rate_iterations):
                eps = draw((2, it), "eps", post[0].shape)
                loss = _rate_loss(model, y_tilde, *post, eps, num_pixels)
                grads = torch.autograd.grad(loss, post)
                adam = adam_update(post, grads, adam, spec.rate_lr)
                rate_losses[it] = loss.detach()
            timing["rate_ms"] = stop()
            z_mean, z_logvar = (t.detach() for t in post)
        self.last_timing = timing

        generator.manual_seed(seed + 1)
        eps = draw(None, "eps", z_mean.shape)
        compute_msssim = min(x.shape[1], x.shape[2]) >= MSSSIM_MIN_SIDE
        metrics = _bb_eval(model, x, y_tilde, z_mean, z_logvar, eps, compute_msssim)
        return dict(
            y=y_tilde.cpu().numpy(),
            z_mean=z_mean.cpu().numpy(),
            z_logvar=z_logvar.cpu().numpy(),
            rd_losses=rd_losses.cpu().numpy(),
            rate_losses=rate_losses.cpu().numpy(),
            **to_numpy(metrics),
        )
