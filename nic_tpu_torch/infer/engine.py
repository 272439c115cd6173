"""Iterative latent optimization, SGA (counterpart of nic_tpu/infer/engine.py).

The loop runs on the device with no host sync per step: the temperature
and Adam's step size come from the step number on the host, the loss of
each step goes into a preallocated device tensor, and the losses are copied
to the host once at the end. nic_tpu's chunking of the loop exists for a TPU
watchdog and has no counterpart here.

Noise: each step draws the Gumbel noise of z and of y from a
``torch.Generator`` on the device, seeded from ``seed``. A caller may
instead pass ``gumbel_fn(step, name, shape)``, name "y" or "z", which tests
use to feed JAX's draws.
"""

import time
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from nic_tpu_torch import config
from nic_tpu_torch.evaluation.metrics import msssim as msssim_fn
from nic_tpu_torch.evaluation.metrics import msssim_db as msssim_db_fn
from nic_tpu_torch.evaluation.metrics import psnr as psnr_fn
from nic_tpu_torch.infer.adam import adam_init, adam_update
from nic_tpu_torch.infer.methods import SGA, MethodSpec, get_method
from nic_tpu_torch.models.mbt2018 import LN2, MeanScaleHyperprior
from nic_tpu_torch.ops.quantize import sga_relax
from nic_tpu_torch.ops.schedules import annealed_temperature

GumbelFn = Callable[[int, str, tuple], torch.Tensor]


class Latents(NamedTuple):
    y: torch.Tensor
    z: torch.Tensor


# --------------------------------------------------------------------- core


def _relax(method: str, v, temperature, generator=None, gumbel=None):
    if method != "sga":
        get_method(method)  # raises: the other relaxations are not ported yet
    return sga_relax(v, temperature, generator=generator, gumbel=gumbel)


def _forward(model: MeanScaleHyperprior, latents: Latents, x, temperature,
             method: str, noise: Optional[Latents] = None, generator=None):
    """Relax -> likelihoods -> reconstruction. ``noise`` holds the Gumbel
    draws of y and z, or None to draw them from ``generator``."""
    noise = noise or Latents(None, None)
    z_tilde = _relax(method, latents.z, temperature, generator, noise.z)
    z_lik = model.z_likelihood(z_tilde)
    y_hw = (latents.y.shape[1], latents.y.shape[2])
    mu, sigma = model.hyper_synthesize(z_tilde, y_hw)
    y_tilde = _relax(method, latents.y, temperature, generator, noise.y)
    y_lik = model.y_likelihood(y_tilde, mu, sigma)
    x_tilde = model.synthesize(y_tilde, (x.shape[1], x.shape[2]))
    return y_tilde, z_tilde, y_lik, z_lik, mu, sigma, x_tilde


def _rd_loss(model, latents: Latents, x, lmbda: float, temperature,
             method: str, noise: Optional[Latents] = None, generator=None):
    """lambda * 255^2 * MSE + mean bpp; (loss, dict(mse, bpp))."""
    _, _, y_lik, z_lik, _, _, x_tilde = _forward(
        model, latents, x, temperature, method, noise, generator
    )
    num_pixels = x.shape[1] * x.shape[2]
    y_bpp = -torch.sum(torch.log(y_lik), dim=(1, 2, 3)) / (LN2 * num_pixels)
    z_bpp = -torch.sum(torch.log(z_lik), dim=(1, 2, 3)) / (LN2 * num_pixels)
    train_bpp = torch.mean(y_bpp + z_bpp)
    mse = torch.mean(torch.square(x - x_tilde)) * (255.0 ** 2)
    loss = lmbda * mse + train_bpp if lmbda > 0 else train_bpp
    return loss, dict(mse=mse, bpp=train_bpp)


def _quantize_transmitted(latents: Latents) -> Latents:
    """The latents SGA transmits: plain rounding."""
    return Latents(y=torch.round(latents.y), z=torch.round(latents.z))


@torch.no_grad()
def _amortized_init(model, x):
    """y = g_a(x), z = h_a(y): the amortized starting point."""
    y = model.analyze(x)
    z = model.hyper_analyze(y)
    return y, z


@torch.no_grad()
def _eval_transmitted(model, x, latents: Latents, compute_msssim: bool):
    """Metrics of the transmitted latents: estimated rates from the
    likelihoods, distortion of the reconstruction rounded to 8 bits."""
    z_lik = model.z_likelihood(latents.z)
    y_hw = (latents.y.shape[1], latents.y.shape[2])
    mu, sigma = model.hyper_synthesize(latents.z, y_hw)
    y_lik = model.y_likelihood(latents.y, mu, sigma)
    x_tilde = model.synthesize(latents.y, (x.shape[1], x.shape[2]))

    num_pixels = x.shape[1] * x.shape[2]
    y_bpp = -torch.sum(torch.log(y_lik), dim=(1, 2, 3)) / (LN2 * num_pixels)
    z_bpp = -torch.sum(torch.log(z_lik), dim=(1, 2, 3)) / (LN2 * num_pixels)

    x255 = x * 255.0
    xt255 = torch.round(torch.clamp(x_tilde, 0.0, 1.0) * 255.0)
    mse = torch.mean(torch.square(x255 - xt255), dim=(1, 2, 3))
    psnr = psnr_fn(xt255, x255, 255.0)
    if compute_msssim:
        ms = msssim_fn(xt255, x255, 255.0)
        ms_db = msssim_db_fn(ms)
    else:
        ms = torch.full(x.shape[:1], float("nan"), device=x.device)
        ms_db = torch.full(x.shape[:1], float("nan"), device=x.device)
    return dict(
        mse=mse,
        psnr=psnr,
        msssim=ms,
        msssim_db=ms_db,
        est_bpp=y_bpp + z_bpp,
        est_y_bpp=y_bpp,
        est_z_bpp=z_bpp,
        x_tilde=x_tilde,
    )


def _to_numpy(metrics: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in metrics.items()}


# ------------------------------------------------------------------- engine


class LatentOptimizer:
    """Binds a model to a device; runs SGA over an image batch.

    The model is moved to ``device`` (the card unless the caller asks for
    the CPU), put in eval mode and frozen: only the latents are optimized.
    """

    def __init__(self, model: MeanScaleHyperprior, device="cuda"):
        config.set_fp32_precision()
        self.device = config.resolve_device(device)
        self.model = model.to(self.device).eval().requires_grad_(False)
        # Device time of the last optimize() loop: {"steps", "loop_ms"}.
        self.last_timing: Dict[str, float] = {}

    def _tensor(self, x):
        return torch.from_numpy(np.array(x, np.float32)).to(self.device)

    def amortized_init(self, x):
        return _amortized_init(self.model, self._tensor(x))

    def _timer(self):
        """Start a timer; returns a callable giving the elapsed ms. CUDA
        events on the card, the host clock on the CPU."""
        if self.device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()

            def stop():
                end.record()
                end.synchronize()
                return start.elapsed_time(end)

            return stop
        t0 = time.perf_counter()
        return lambda: (time.perf_counter() - t0) * 1e3

    def optimize(self, x, lmbda: float, method: MethodSpec = SGA, seed: int = 0,
                 gumbel_fn: Optional[GumbelFn] = None) -> Dict[str, np.ndarray]:
        """Run the full iterative inference for one image batch.

        Returns the transmitted latents, the per-image eval metrics, and the
        per-iteration loss history, under nic_tpu's keys.
        """
        get_method(method.name)
        x = self._tensor(x)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        y0, z0 = _amortized_init(self.model, x)
        y = y0.clone().requires_grad_(True)
        z = z0.clone().requires_grad_(True)
        state = adam_init((y, z))
        losses = torch.empty(method.iterations, device=self.device)
        stop = self._timer()
        for it in range(method.iterations):
            temperature = annealed_temperature(
                it, r=method.annealing_rate, ub=method.temperature_ub,
                scheme=method.annealing_scheme, t0=method.t0,
            )
            noise = None
            if gumbel_fn is not None:
                noise = Latents(
                    y=gumbel_fn(it, "y", tuple(y.shape) + (2,)).to(self.device),
                    z=gumbel_fn(it, "z", tuple(z.shape) + (2,)).to(self.device),
                )
            loss, _ = _rd_loss(
                self.model, Latents(y, z), x, lmbda, temperature, method.name,
                noise, generator,
            )
            grads = torch.autograd.grad(loss, (y, z))
            state = adam_update((y, z), grads, state, method.lr)
            losses[it] = loss.detach()
        self.last_timing = dict(steps=method.iterations, loop_ms=stop())

        transmitted = _quantize_transmitted(Latents(y.detach(), z.detach()))
        compute_msssim = min(x.shape[1], x.shape[2]) >= 176
        metrics = _eval_transmitted(self.model, x, transmitted, compute_msssim)
        return dict(
            y=transmitted.y.cpu().numpy(),
            z=transmitted.z.cpu().numpy(),
            losses=losses.cpu().numpy(),
            # The rounded-objective probes (--verbose) are not ported.
            rounded_losses=np.full(method.iterations, np.nan, np.float32),
            **_to_numpy(metrics),
        )

    def eval_rounded(self, x, y, z) -> Dict[str, np.ndarray]:
        """Evaluate plainly-rounded latents."""
        x = self._tensor(x)
        latents = Latents(y=torch.round(self._tensor(y)), z=torch.round(self._tensor(z)))
        compute_msssim = min(x.shape[1], x.shape[2]) >= 176
        return _to_numpy(_eval_transmitted(self.model, x, latents, compute_msssim))

    @torch.no_grad()
    def eval_amortized(self, x) -> Dict[str, np.ndarray]:
        """No-optimization baseline: quantize the amortized latents."""
        x = self._tensor(x)
        out = self.model(x)
        compute_msssim = min(x.shape[1], x.shape[2]) >= 176
        metrics = _eval_transmitted(
            self.model, x, Latents(y=out["y_tilde"], z=out["z_tilde"]), compute_msssim
        )
        return _to_numpy(metrics)
