"""Iterative latent optimization: sga, map, ste, unoise and danneal
(counterpart of nic_tpu/infer/engine.py).

The loop runs on the device. The temperature and Adam's step size come
from the step number on the host, the loss of each step goes into a
preallocated device tensor, and the losses are copied to the host once at
the end. The fixed-length methods (sga, unoise, danneal) need no host sync
per step, and their ``--verbose`` probes also go into a device tensor. map
and ste stop early: every ``probe_interval`` steps and at the last step the
host reads one probe value (one sync), keeps the latents while the probe
improves and stops at the first probe that does not. nic_tpu's chunking of
the loop exists for a TPU watchdog and has no counterpart here.

Noise: each step draws sga's Gumbel noise or unoise's uniform noise of z,
then of y, from a ``torch.Generator`` on the device, seeded from ``seed``;
unoise's "noisy_z" transmit draw comes from a second generator derived from
the seed. A caller may instead pass ``noise_fn(step, name, shape)``, name
"y", "z" or "transmit" (step None), which tests use to feed JAX's draws.

Data parallelism (nic_tpu's ``LatentOptimizer(mesh=...)``): given a process
group, each rank optimizes its slice of the batch. The loss is the global
batch mean, from each rank's partial sums (the gradient of a rank's latents
is that of its own partial), and the logged losses and the probes that
decide the early stop are reduced over the ranks. The noise is drawn at the
global batch's shape from the generator every rank shares, and each rank
keeps its images' draws, so the ranks compute what one process would. The
results are gathered: every rank returns the whole batch's. A batch that
the ranks do not divide runs whole on every rank, with nic_tpu's warning.
"""

import contextlib
import time
import warnings
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from nic_tpu_torch import config
from nic_tpu_torch.evaluation.metrics import msssim as msssim_fn
from nic_tpu_torch.evaluation.metrics import msssim_db as msssim_db_fn
from nic_tpu_torch.evaluation.metrics import psnr as psnr_fn
from nic_tpu_torch.infer.adam import adam_init, adam_update
from nic_tpu_torch.infer.methods import SGA, MethodSpec, get_method
from nic_tpu_torch.models.layers import SignalConv
from nic_tpu_torch.models.mbt2018 import LN2, MeanScaleHyperprior
from nic_tpu_torch.ops.quantize import (
    danneal_relax,
    draw_gumbel,
    draw_uniform,
    round_ste,
    sga_relax,
    uniform_noise,
)
from nic_tpu_torch.ops.schedules import annealed_temperature
from nic_tpu_torch.parallel.mesh import Comm

NoiseFn = Callable[[Optional[int], str, tuple], torch.Tensor]
# Offset of the unoise transmit generator's seed from the loop's.
TRANSMIT_SEED_OFFSET = 0x7A31
# The 5-scale MS-SSIM window needs 11 * 2^4 pixels on the short side.
MSSSIM_MIN_SIDE = 176


class Latents(NamedTuple):
    y: torch.Tensor
    z: torch.Tensor


# --------------------------------------------------------------------- core


def _relax(method: str, v, temperature, noise=None):
    """The method's relaxation of rounding; ``noise`` holds sga's Gumbel or
    unoise's uniform draws."""
    if method == "sga":
        return sga_relax(v, temperature, gumbel=noise)
    if method == "danneal":
        return danneal_relax(v, temperature)
    if method == "map":
        return v
    if method == "ste":
        return round_ste(v)
    if method == "unoise":
        return uniform_noise(v, noise=noise)
    raise ValueError(f"Unknown relaxation {method!r}")


def _forward(model: MeanScaleHyperprior, latents: Latents, x, temperature,
             method: str, noise: Optional[Latents] = None):
    """Relax -> likelihoods -> reconstruction. ``noise`` holds the draws of
    y and z (sga, unoise)."""
    noise = noise or Latents(None, None)
    z_tilde = _relax(method, latents.z, temperature, noise.z)
    z_lik = model.z_likelihood(z_tilde)
    y_hw = (latents.y.shape[1], latents.y.shape[2])
    mu, sigma = model.hyper_synthesize(z_tilde, y_hw)
    y_tilde = _relax(method, latents.y, temperature, noise.y)
    y_lik = model.y_likelihood(y_tilde, mu, sigma)
    x_tilde = model.synthesize(y_tilde, (x.shape[1], x.shape[2]))
    return y_tilde, z_tilde, y_lik, z_lik, mu, sigma, x_tilde


def _rd_loss(model, latents: Latents, x, lmbda: float, temperature,
             method: str, noise: Optional[Latents] = None,
             distortion: str = "mse", batch: Optional[int] = None):
    """lambda * distortion + mean bpp; (loss, dict(mse, bpp)). The
    distortion is 255^2 * MSE, or 1 - MS-SSIM with ``distortion="msssim"``.
    The means are over ``batch`` images (default: x's); a data-parallel
    rank passes the global batch and gets its share of the global loss."""
    _, _, y_lik, z_lik, _, _, x_tilde = _forward(model, latents, x, temperature, method, noise)
    batch = batch or x.shape[0]
    y_bpp, z_bpp = _bpp(y_lik, z_lik, x)
    train_bpp = torch.sum(y_bpp + z_bpp) / batch
    mse = torch.sum(torch.square(x - x_tilde)) / (batch * x[0].numel()) * (255.0 ** 2)
    if distortion == "msssim":
        dist = torch.sum(1.0 - msssim_fn(x_tilde, x, 1.0)) / batch
    else:
        dist = mse
    loss = lmbda * dist + train_bpp if lmbda > 0 else train_bpp
    return loss, dict(mse=mse, bpp=train_bpp)


def _bpp(y_lik, z_lik, x):
    """Each image's estimated bits per pixel of y and of z."""
    num_pixels = x.shape[1] * x.shape[2]
    y_bpp = -torch.sum(torch.log(y_lik), dim=(1, 2, 3)) / (LN2 * num_pixels)
    z_bpp = -torch.sum(torch.log(z_lik), dim=(1, 2, 3)) / (LN2 * num_pixels)
    return y_bpp, z_bpp


@torch.no_grad()
def rd_objective_per_image(model, latents: Latents, x, lmbda: float):
    """Each image's own continuous (MAP: latents unrounded) ``_rd_loss``
    objective, 255^2 MSE distortion, as if it were evaluated alone: a batch
    of independent evaluations, e.g. copies of one image's latents that
    differ in a few coordinates."""
    _, _, y_lik, z_lik, _, _, x_tilde = _forward(model, latents, x, 1.0, "map")
    y_bpp, z_bpp = _bpp(y_lik, z_lik, x)
    mse = torch.mean(torch.square(x - x_tilde), dim=(1, 2, 3)) * (255.0 ** 2)
    return lmbda * mse + (y_bpp + z_bpp) if lmbda > 0 else y_bpp + z_bpp


@torch.no_grad()
def _quantize_transmitted(model, latents: Latents, method: str,
                          unoise_mu_source: str = "quantized_z",
                          transmit_noise=None) -> Latents:
    """The latents each method transmits.

    sga, ste, danneal: plain rounding. map: median-centered z, and y
    centered on the mean from the continuous z. unoise: the same quantizers,
    the mean from the quantized z ("quantized_z", decodable) or from
    z + ``transmit_noise``, a U(-.5, .5) draw ("noisy_z").
    """
    if method in ("sga", "ste", "danneal"):
        return Latents(y=torch.round(latents.y), z=torch.round(latents.z))
    z_hat = model.quantize_z(latents.z)
    y_hw = (latents.y.shape[1], latents.y.shape[2])
    if method == "map":
        mu_src = latents.z
    elif method == "unoise":
        mu_src = latents.z + transmit_noise if unoise_mu_source == "noisy_z" else z_hat
    else:
        raise ValueError(method)
    mu, _ = model.hyper_synthesize(mu_src, y_hw)
    return Latents(y=model.conditional.quantize(latents.y, mu), z=z_hat)


@torch.no_grad()
def _probe_objective(model, latents: Latents, x, lmbda: float, method: str,
                     distortion: str = "mse", batch: Optional[int] = None):
    """The discrete objective after quantization, with the identity
    relaxation on the quantized latents: the early stop's and --verbose's
    probe (a rank's share of it with a global ``batch``)."""
    q = _quantize_transmitted(model, latents, method)
    loss, _ = _rd_loss(model, q, x, lmbda, 1.0, "map", distortion=distortion, batch=batch)
    return loss


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
    y_bpp, z_bpp = _bpp(y_lik, z_lik, x)
    return dict(
        **distortion_metrics(x, x_tilde, compute_msssim),
        est_bpp=y_bpp + z_bpp,
        est_y_bpp=y_bpp,
        est_z_bpp=z_bpp,
        x_tilde=x_tilde,
    )


def distortion_metrics(x, x_tilde, compute_msssim: bool) -> Dict[str, torch.Tensor]:
    """Per-image mse, psnr, msssim and msssim_db of the reconstruction
    rounded to 8 bits (NaN MS-SSIM unless ``compute_msssim``)."""
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
    return dict(mse=mse, psnr=psnr, msssim=ms, msssim_db=ms_db)


def device_timer(device: torch.device):
    """Start a timer; returns a callable giving the elapsed ms. CUDA events
    on the card, the host clock on the CPU."""
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()

        def stop():
            end.record()
            end.synchronize()
            return start.elapsed_time(end)

        return stop
    t0 = time.perf_counter()
    return lambda: (time.perf_counter() - t0) * 1e3


def to_numpy(metrics: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in metrics.items()}


@contextlib.contextmanager
def global_scales(model, comm: Comm):
    """While several ranks hold parts of one batch, the int8 layers' per-tensor
    scales are the whole batch's: their max|x| is reduced over the ranks
    (``SignalConv.scale_reduce``), as under nic_tpu's jit over a sharded
    batch. Scoped to one call, so that a rank's own codec pass reduces
    nothing."""
    layers = [m for m in model.modules()
              if isinstance(m, SignalConv) and m.quant is not None] if comm.size > 1 else []
    for m in layers:
        m.scale_reduce = comm.max
    try:
        yield
    finally:
        for m in layers:
            m.scale_reduce = None


# ------------------------------------------------------------------- engine


class LatentOptimizer:
    """Binds a model to a device; runs any method over an image batch.

    The model is moved to ``device`` (the card unless the caller asks for
    the CPU), put in eval mode and frozen: only the latents are optimized.
    With a process ``group`` of several ranks, ``optimize`` shards the batch
    over them (see the module's docstring); every rank makes the same call.
    """

    def __init__(self, model: MeanScaleHyperprior, device="cuda", group=None):
        config.set_fp32_precision()
        self.device = config.resolve_device(device)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.comm = Comm(group)
        # Device time of the last optimize() loop: {"steps", "loop_ms"}.
        self.last_timing: Dict[str, float] = {}

    def _tensor(self, x):
        return torch.from_numpy(np.array(x, np.float32)).to(self.device)

    def amortized_init(self, x):
        return _amortized_init(self.model, self._tensor(x))

    def _batch_comm(self, batch: int) -> Comm:
        """The ranks this batch is sharded over: all of them, or none (a
        single ``Comm``) when they do not divide it."""
        if batch % self.comm.size == 0:
            return self.comm
        warnings.warn(
            f"batch of {batch} does not divide the {self.comm.size}-device data "
            "mesh; this batch runs replicated (no data parallelism). Pick eval "
            "batch sizes divisible by the mesh to keep all chips busy.",
            stacklevel=3,
        )
        return Comm()

    def optimize(self, x, lmbda: float, method: MethodSpec = SGA, seed: int = 0,
                 noise_fn: Optional[NoiseFn] = None, probe_every: int = 0,
                 record_every: int = 0) -> Dict[str, np.ndarray]:
        """Run the full iterative inference for one image batch.

        Returns the transmitted latents, the per-image eval metrics and, for
        the fixed-length methods, the loss of every step (``losses``) and the
        rounded objective every ``probe_every`` steps, NaN elsewhere
        (``rounded_losses``: the --verbose probes); the early-stopping
        methods return both empty, as nic_tpu does. ``last_timing`` holds
        the steps actually run and the loop's device time.

        ``record_every`` > 0 also records the continuous latents at step 0
        and after every ``record_every`` steps and the last one (the
        trajectory of nic_tpu's scripts/sga_landscape.py): ``trajectory_y``
        and ``trajectory_z`` [rows, N, ...] and ``trajectory_temperatures``
        (each row's last step's temperature; NaN for row 0). The rows stay
        on the device until the loop ends. An early-stopping method's rows
        end where it stopped.
        """
        get_method(method.name)
        x = self._tensor(x)
        if method.distortion == "msssim" and min(x.shape[1], x.shape[2]) < MSSSIM_MIN_SIDE:
            raise ValueError(
                "msssim optimization objective needs images >= 176px on the "
                f"short side (5 scales x 11-tap window); got {tuple(x.shape[1:3])}."
            )
        comm = self._batch_comm(x.shape[0])
        with global_scales(self.model, comm):
            return self._optimize(x, comm, lmbda, method, seed, noise_fn, probe_every,
                                  record_every)

    def _optimize(self, x, comm: Comm, lmbda: float, method: MethodSpec, seed: int,
                  noise_fn: Optional[NoiseFn], probe_every: int,
                  record_every: int) -> Dict[str, np.ndarray]:
        batch = x.shape[0]
        lo, hi = comm.shard(batch)
        x = x[lo:hi]
        generator = torch.Generator(device=self.device).manual_seed(seed)
        y0, z0 = _amortized_init(self.model, x)
        y = y0.clone().requires_grad_(True)
        z = z0.clone().requires_grad_(True)
        state = adam_init((y, z))
        its = method.iterations
        losses = torch.empty(its, device=self.device)
        probes = torch.full((its,), float("nan"), device=self.device)
        # Early stop: the latents of the last improving probe.
        saved, prev_obj, stopped, steps = None, float("inf"), False, its
        # The recorded rows: (temperature, y, z), device copies.
        rows = [(float("nan"), y0, z0)] if record_every > 0 else None

        # sga draws a Gumbel pair per latent, unoise one uniform draw; each
        # at the global batch's shape, this rank's images kept.
        draw_fn = {"sga": draw_gumbel, "unoise": draw_uniform}.get(method.name)
        pair = (2,) if method.name == "sga" else ()

        def draw(it, name, v):
            shape = (batch,) + tuple(v.shape[1:]) + pair
            if noise_fn is not None:
                return noise_fn(it, name, shape)[lo:hi].to(self.device)
            return draw_fn(shape, generator, self.device)[lo:hi]

        def reduced(loss):
            return comm.all_reduce(loss.detach().clone())

        stop = device_timer(self.device)
        for it in range(its):
            temperature = annealed_temperature(
                it, r=method.annealing_rate, ub=method.temperature_ub,
                scheme=method.annealing_scheme, t0=method.t0,
            )
            noise = None
            if draw_fn is not None:
                noise_z = draw(it, "z", z)
                noise = Latents(y=draw(it, "y", y), z=noise_z)
            loss, _ = _rd_loss(
                self.model, Latents(y, z), x, lmbda, temperature, method.name,
                noise, method.distortion, batch,
            )
            grads = torch.autograd.grad(loss, (y, z))
            state = adam_update((y, z), grads, state, method.lr)
            if rows is not None and ((it + 1) % record_every == 0 or it == its - 1):
                rows.append((temperature, y.detach().clone(), z.detach().clone()))
            loss = reduced(loss)
            if not method.early_stop:
                losses[it] = loss
                if probe_every > 0 and it % probe_every == 0:
                    probes[it] = reduced(_probe_objective(
                        self.model, Latents(y, z), x, lmbda, method.name,
                        method.distortion, batch))
                continue
            if it % method.probe_interval and it != its - 1:
                continue
            # STE compares the relaxed objective of this step itself.
            obj = loss if method.name == "ste" else reduced(_probe_objective(
                self.model, Latents(y, z), x, lmbda, method.name, method.distortion,
                batch))
            obj = float(obj)  # the host decides: one sync per probe
            if obj <= prev_obj:
                saved = Latents(y.detach().clone(), z.detach().clone())
                prev_obj = obj
            else:
                stopped, steps = True, it + 1
                break
        self.last_timing = dict(steps=steps, loop_ms=stop())

        final = saved if stopped else Latents(y.detach(), z.detach())
        transmit_noise = None
        if method.name == "unoise" and method.unoise_mu_source == "noisy_z":
            shape = (batch,) + tuple(z.shape[1:])
            if noise_fn is not None:
                transmit_noise = noise_fn(None, "transmit", shape)[lo:hi].to(self.device)
            else:
                transmit = torch.Generator(device=self.device).manual_seed(
                    seed + TRANSMIT_SEED_OFFSET)
                transmit_noise = draw_uniform(shape, transmit, self.device)[lo:hi]
        transmitted = _quantize_transmitted(
            self.model, final, method.name, method.unoise_mu_source, transmit_noise)
        compute_msssim = min(x.shape[1], x.shape[2]) >= MSSSIM_MIN_SIDE
        metrics = _eval_transmitted(self.model, x, transmitted, compute_msssim)
        metrics.update(y=transmitted.y, z=transmitted.z)
        metrics = {k: comm.all_gather_cat(v, 0) for k, v in metrics.items()}
        if rows is not None:
            temperatures, ys, zs = zip(*rows)
            metrics.update(
                trajectory_y=comm.all_gather_cat(torch.stack(ys), 1),
                trajectory_z=comm.all_gather_cat(torch.stack(zs), 1),
                trajectory_temperatures=torch.tensor(temperatures, dtype=torch.float32))
        if method.early_stop:
            losses = probes = torch.zeros(0)
        return dict(
            losses=losses.cpu().numpy(),
            rounded_losses=probes.cpu().numpy(),
            **to_numpy(metrics),
        )

    def eval_rounded(self, x, y, z) -> Dict[str, np.ndarray]:
        """Evaluate plainly-rounded latents."""
        x = self._tensor(x)
        latents = Latents(y=torch.round(self._tensor(y)), z=torch.round(self._tensor(z)))
        compute_msssim = min(x.shape[1], x.shape[2]) >= MSSSIM_MIN_SIDE
        return to_numpy(_eval_transmitted(self.model, x, latents, compute_msssim))

    @torch.no_grad()
    def eval_amortized(self, x) -> Dict[str, np.ndarray]:
        """No-optimization baseline: quantize the amortized latents."""
        x = self._tensor(x)
        out = self.model(x)
        compute_msssim = min(x.shape[1], x.shape[2]) >= MSSSIM_MIN_SIDE
        metrics = _eval_transmitted(
            self.model, x, Latents(y=out["y_tilde"], z=out["z_tilde"]), compute_msssim
        )
        return to_numpy(metrics)
