"""Row-sharded single-image inference with a per-layer halo exchange
(counterpart of nic_tpu/parallel/spatial.py).

One image's rows are split over the ranks of a process group, and every rank
runs the whole iterative inference on its rows:
- g_a and g_s, the transforms at image and y resolution, run on row shards.
  Before each 5x5 conv a rank takes 2 rows from each neighbour
  (``HaloExchange``), runs the conv on the extended slab and crops it. The
  ranks at the edges of the image get zero rows, which is the SAME zero
  padding the unsharded conv applies, so the sharded transforms compute the
  unsharded ones. K1 runs in their GDN and IGDN on the card.
- z, 64x down, is replicated: y is gathered, h_a, the z prior and h_s run
  on every rank alike, and each rank slices its rows of (mu, sigma). z's
  gradient is summed over the ranks before Adam, and its noise comes from a
  generator every rank shares, so z stays the same on every rank.
- The RD loss is the sum of the ranks' partial sums, the replicated z term
  divided by the number of ranks. A rank differentiates its own partial;
  the halo exchange's backward carries the other ranks' cotangents to its
  rows, so its latents get the gradient of the global loss.

Under ``quant`` (int8 transforms) h_s runs in int8 on every rank alike, on
the whole z, and the row-sharded g_s in float, as nic_tpu's spatial path
builds it: a shard's own int8 scale would not be the image's.

Per step the ranks exchange two halos per g_s layer (forward and backward)
and reduce z's gradient and the loss. The collectives are ``all_gather`` and
``all_reduce`` only (``parallel/mesh.py``).
"""

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from nic_tpu_torch import config
from nic_tpu_torch.evaluation.metrics import msssim as msssim_fn
from nic_tpu_torch.evaluation.metrics import msssim_db as msssim_db_fn
from nic_tpu_torch.infer.adam import adam_init, adam_update
from nic_tpu_torch.infer.engine import MSSSIM_MIN_SIDE, Latents, NoiseFn, _relax, device_timer
from nic_tpu_torch.infer.methods import SGA, MethodSpec, get_method
from nic_tpu_torch.models.mbt2018 import LN2, MeanScaleHyperprior
from nic_tpu_torch.ops.quantize import draw_gumbel, draw_uniform
from nic_tpu_torch.ops.schedules import annealed_temperature
from nic_tpu_torch.parallel.mesh import Comm

# Rows taken from each neighbour before every 5x5 conv: they cover the
# window of a stride-2 conv ([2o-1, 2o+3]) and of a stride-2 transposed one.
HALO = 2


class HaloExchange(torch.autograd.Function):
    """(N, Hs, W, C) row shard -> (N, Hs + 2*HALO, W, C): HALO rows from the
    rank above on top, HALO from the rank below at the bottom, zeros at the
    image's edges.

    Forward: each rank's top and bottom HALO rows are all-gathered. Backward,
    its transpose: the cotangents of the rows a rank received are gathered
    back and added to the rows of the ranks that sent them."""

    @staticmethod
    def forward(ctx, x, comm: Comm):
        ctx.comm = comm
        edges = comm.all_gather(torch.cat([x[:, :HALO], x[:, -HALO:]], dim=1))
        r, n = comm.rank, comm.size
        zeros = x.new_zeros(x[:, :HALO].shape)
        above = edges[r - 1][:, HALO:] if r > 0 else zeros
        below = edges[r + 1][:, :HALO] if r < n - 1 else zeros
        return torch.cat([above, x, below], dim=1)

    @staticmethod
    def backward(ctx, g):
        comm = ctx.comm
        r, n = comm.rank, comm.size
        sent = comm.all_gather(torch.cat([g[:, :HALO], g[:, -HALO:]], dim=1))
        dx = g[:, HALO:-HALO].clone()
        if r > 0:  # my top rows were the rank above's bottom halo
            dx[:, :HALO] += sent[r - 1][:, HALO:]
        if r < n - 1:  # my bottom rows were the rank below's top halo
            dx[:, -HALO:] += sent[r + 1][:, :HALO]
        return dx, None


def _conv_down2(layer, x):
    """A 5x5 stride-2 conv on a halo-extended slab, cropped to this shard's
    rows: SAME on the slab gives the global window of every kept row
    (shard offsets are even)."""
    return layer(x)[:, 1:-1]


def _conv_up2(layer, x):
    """A 5x5 up-2 conv on a halo-extended slab: 2 * (Hs + 4) rows, the
    shard's 2 * Hs from row 4 (2 * HALO). Always the float transposed form:
    nic_tpu's sharded g_s builds its layers without ``quant`` or
    ``upsample_impl`` (a per-shard int8 scale would not be the image's);
    h_s, on the whole z, keeps the model's."""
    return layer(x, plain=True)[:, 2 * HALO:-2 * HALO]


def analyze_sharded(model: MeanScaleHyperprior, x_local, comm: Comm):
    """This shard's rows of y = g_a(x) (3 x [conv5/down2 + GDN] + conv5/down2)."""
    g = model.analysis
    h = x_local
    for i in range(3):
        h = _conv_down2(getattr(g, f"layer_{i}"), HaloExchange.apply(h, comm))
        h = getattr(g, f"gdn_{i}")(h)
    return _conv_down2(g.layer_3, HaloExchange.apply(h, comm)).float()


def synthesize_sharded(model: MeanScaleHyperprior, y_local, comm: Comm):
    """This shard's rows of x_tilde = g_s(y) (3 x [conv5/up2 + IGDN] + conv5/up2)."""
    g = model.synthesis
    h = y_local
    for i in range(3):
        h = _conv_up2(getattr(g, f"layer_{i}"), HaloExchange.apply(h, comm))
        h = getattr(g, f"igdn_{i}")(h)
    return _conv_up2(g.layer_3, HaloExchange.apply(h, comm)).float()


def _slice_rows(t, rows: int, comm: Comm):
    return t[:, comm.rank * rows:(comm.rank + 1) * rows]


def _loss_local(model, latents: Latents, x_local, lmbda: float, num_pixels: int,
                temperature, method: str, noise: Latents, comm: Comm):
    """This rank's partial of the global RD objective (the partials sum to
    lambda * mse + bpp) and its (mse, bpp) partials. ``latents.y`` holds this
    shard's rows, ``latents.z`` the replicated z."""
    y_tilde = _relax(method, latents.y, temperature, noise=noise.y)
    z_tilde = _relax(method, latents.z, temperature, noise=noise.z)
    z_lik = model.z_likelihood(z_tilde)
    mu, sigma = model.hyper_synthesize(z_tilde)
    rows = latents.y.shape[1]
    y_lik = model.y_likelihood(y_tilde, _slice_rows(mu, rows, comm),
                               _slice_rows(sigma, rows, comm))
    x_tilde = synthesize_sharded(model, y_tilde, comm)
    batch = x_local.shape[0]
    sq = torch.sum(torch.square(x_local - x_tilde))
    y_bits = -torch.sum(torch.log(y_lik)) / LN2
    # The replicated z term is divided by the ranks so the sum counts it once.
    z_bits = -torch.sum(torch.log(z_lik)) / (LN2 * comm.size)
    bpp = (y_bits + z_bits) / (num_pixels * batch)
    mse = (255.0 ** 2) * sq / (num_pixels * batch * 3)
    return lmbda * mse + bpp, (mse, bpp)


@torch.no_grad()
def _quantize_local(model, method: str, y_local, z, comm: Comm) -> Latents:
    """The transmitted latents (engine._quantize_transmitted) of this shard:
    sga, ste, danneal round; map and unoise center y on the mean from the
    continuous (map) or the quantized z, and z on the medians."""
    if method in ("sga", "ste", "danneal"):
        return Latents(torch.round(y_local), torch.round(z))
    z_hat = model.quantize_z(z)
    mu, _ = model.hyper_synthesize(z if method == "map" else z_hat)
    mu = _slice_rows(mu, y_local.shape[1], comm)
    return Latents(model.conditional.quantize(y_local, mu), z_hat)


@torch.no_grad()
def _probe_objective(model, latents: Latents, x_local, lmbda, num_pixels, method, comm):
    """The rounded objective, reduced: the same on every rank, so the early
    stop takes the same branch on all."""
    q = _quantize_local(model, method, latents.y, latents.z, comm)
    loss, _ = _loss_local(model, q, x_local, lmbda, num_pixels, 1.0, "map",
                          Latents(None, None), comm)
    return comm.all_reduce(loss)


@torch.no_grad()
def _eval_transmitted(model, x_local, q: Latents, comm: Comm) -> Dict[str, torch.Tensor]:
    """Per-image metrics of the transmitted latents from reduced partial sums;
    x_tilde gathered whole."""
    z_lik = model.z_likelihood(q.z)
    mu, sigma = model.hyper_synthesize(q.z)
    rows = q.y.shape[1]
    y_lik = model.y_likelihood(q.y, _slice_rows(mu, rows, comm), _slice_rows(sigma, rows, comm))
    x_tilde = synthesize_sharded(model, q.y, comm)
    num_pixels = x_local.shape[1] * comm.size * x_local.shape[2]
    xt255 = torch.round(torch.clamp(x_tilde, 0.0, 1.0) * 255.0)
    sq = torch.sum(torch.square(x_local * 255.0 - xt255), dim=(1, 2, 3))
    y_bits = -torch.sum(torch.log(y_lik), dim=(1, 2, 3)) / LN2
    z_bits = -torch.sum(torch.log(z_lik), dim=(1, 2, 3)) / (LN2 * comm.size)
    sq, y_bits, z_bits = comm.all_reduce(torch.stack([sq, y_bits, z_bits]))
    mse = sq / (num_pixels * 3)
    return dict(
        mse=mse,
        psnr=-10.0 * torch.log(mse / 255.0 ** 2) / math.log(10.0),
        est_y_bpp=y_bits / num_pixels,
        est_z_bpp=z_bits / num_pixels,
        est_bpp=(y_bits + z_bits) / num_pixels,
        x_tilde=comm.all_gather_cat(x_tilde, 1),
    )


class SpatialLatentOptimizer:
    """Iterative inference of ONE large image, its rows sharded over the
    ranks of ``group`` (None: one rank). Every rank makes the same call and
    gets the same result.

    Any image size is edge-padded to the ranks' grid (H to a multiple of
    lcm(64, 16 n) and at least 32 n, W to a multiple of 64); the distortion
    and the returned reconstruction cover the original pixels, and the rate
    is renormalised to their count. Several images run one after another.
    map and ste stop early on the reduced probe, as the batch engine does.
    """

    def __init__(self, model: MeanScaleHyperprior, device="cuda", group=None):
        config.set_fp32_precision()
        self.device = config.resolve_device(device)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.comm = Comm(group)
        # Device time of the last image's loop: {"steps", "loop_ms"}.
        self.last_timing: Dict[str, float] = {}

    @property
    def n(self) -> int:
        return self.comm.size

    def _check(self, h: int, w: int) -> None:
        n = self.n
        if h % 64 or w % 64:
            raise ValueError(f"H, W must be multiples of 64; got {h}x{w}")
        if h % (16 * n):
            raise ValueError(f"H={h} must be a multiple of 16*n_devices={16 * n} "
                             "(whole y rows per shard)")
        if h < 32 * n:
            raise ValueError(f"H={h} too small to shard {n} ways (need >= {32 * n})")

    def _pad_to_grid(self, x: np.ndarray):
        """x edge-padded to the grid, and the original (H, W)."""
        n = self.n
        h, w = x.shape[1], x.shape[2]

        def up(v, m):
            return v + (-v) % m

        m = math.lcm(64, 16 * n)
        hp, wp = max(up(h, m), up(32 * n, m)), up(w, 64)
        if (hp, wp) != (h, w):
            x = np.pad(x, ((0, 0), (0, hp - h), (0, wp - w), (0, 0)), mode="edge")
        return x, (h, w)

    def _local_rows(self, x: np.ndarray) -> torch.Tensor:
        lo, hi = self.comm.shard(x.shape[1])
        return torch.from_numpy(np.ascontiguousarray(x[:, lo:hi])).to(self.device)

    @torch.no_grad()
    def _init_local(self, x_local):
        y = analyze_sharded(self.model, x_local, self.comm)
        z = self.model.hyper_analyze(self.comm.all_gather_cat(y, 1))
        return y, z

    def amortized_init(self, x):
        """(y, z) of an image batch whose size is on the grid: y by the
        sharded g_a (gathered whole), z by h_a on every rank."""
        x = np.asarray(x, np.float32)
        self._check(x.shape[1], x.shape[2])
        y, z = self._init_local(self._local_rows(x))
        return self.comm.all_gather_cat(y, 1), z

    def optimize(self, x, lmbda: float, method: MethodSpec = SGA, seed: int = 0,
                 noise_fn: Optional[NoiseFn] = None,
                 probe_every: int = 0) -> Dict[str, Any]:
        """The batch engine's ``optimize`` surface, image by image (metric
        arrays per image, batch-mean loss records). Without ``noise_fn``, y's
        draws come from a generator of this rank's own and z's from one every
        rank shares; ``noise_fn(step, name, shape)`` takes the global shape,
        and each rank keeps its rows."""
        if method.distortion != "mse":
            raise ValueError(
                "SpatialLatentOptimizer optimizes the MSE objective only "
                f"(got distortion={method.distortion!r}); use the batch "
                "LatentOptimizer for msssim.")
        get_method(method.name)
        if probe_every and method.early_stop:
            probe_every = 0  # early stop probes on its own schedule
        x = np.asarray(x, np.float32)
        if x.ndim == 3:
            x = x[None]
        if x.shape[0] > 1:
            outs = [self.optimize(img[None], lmbda, method, seed, noise_fn, probe_every)
                    for img in x]
            combined = {}
            for k in outs[0]:
                parts = [o[k] for o in outs]
                if k in ("losses", "rounded_losses"):
                    combined[k] = np.mean(np.stack(parts), axis=0) if parts[0].size else parts[0]
                else:
                    combined[k] = np.concatenate([np.atleast_1d(p) for p in parts])
            return combined
        x, (orig_h, orig_w) = self._pad_to_grid(x)
        self._check(x.shape[1], x.shape[2])
        out = self._optimize_image(self._local_rows(x), lmbda, method, seed, noise_fn,
                                   probe_every, x.shape[1] * x.shape[2])
        num_pixels = x.shape[1] * x.shape[2]
        if (orig_h, orig_w) != (x.shape[1], x.shape[2]):
            # The rate codes the padded latents, counted over the original
            # pixels; the distortion covers the original pixels only.
            scale = num_pixels / (orig_h * orig_w)
            for k in ("est_bpp", "est_y_bpp", "est_z_bpp"):
                out[k] = out[k] * scale
            x = x[:, :orig_h, :orig_w]
            xt = out["x_tilde"][:, :orig_h, :orig_w]
            xt255 = np.round(np.clip(xt, 0.0, 1.0) * 255.0)
            out["mse"] = np.mean(np.square(x * 255.0 - xt255), axis=(1, 2, 3)).astype(np.float32)
            out["psnr"] = (-10.0 * np.log(out["mse"] / 255.0 ** 2) / np.log(10.0)).astype(
                np.float32)
            out["x_tilde"] = xt
        if min(orig_h, orig_w) >= MSSSIM_MIN_SIDE:
            x255 = torch.from_numpy(x * 255.0).to(self.device)
            xt255 = torch.round(torch.clamp(
                torch.from_numpy(out["x_tilde"]).to(self.device), 0, 1) * 255.0)
            ms = msssim_fn(xt255, x255, 255.0)
            out["msssim"] = ms.cpu().numpy()
            out["msssim_db"] = msssim_db_fn(ms).cpu().numpy()
        else:
            out["msssim"] = np.full((x.shape[0],), np.nan, np.float32)
            out["msssim_db"] = np.full((x.shape[0],), np.nan, np.float32)
        return out

    def _optimize_image(self, x_local, lmbda, method: MethodSpec, seed, noise_fn,
                        probe_every, num_pixels) -> Dict[str, np.ndarray]:
        comm, model, device = self.comm, self.model, self.device
        y0, z0 = self._init_local(x_local)
        y = y0.clone().requires_grad_(True)
        z = z0.clone().requires_grad_(True)
        state_y, state_z = adam_init((y,)), adam_init((z,))
        rows = y.shape[1]
        y_gen = torch.Generator(device=device).manual_seed(
            int(np.random.SeedSequence([seed, 1 + comm.rank]).generate_state(1)[0]))
        z_gen = torch.Generator(device=device).manual_seed(seed)
        draw_fn = {"sga": draw_gumbel, "unoise": draw_uniform}.get(method.name)
        pair = (2,) if method.name == "sga" else ()

        def draw(it, name):
            if name == "z":
                shape = tuple(z.shape) + pair
                if noise_fn is not None:
                    return noise_fn(it, "z", shape).to(device)
                return draw_fn(shape, z_gen, device)
            if noise_fn is not None:
                full = (y.shape[0], rows * comm.size) + tuple(y.shape[2:]) + pair
                return _slice_rows(noise_fn(it, "y", full), rows, comm).to(device)
            return draw_fn(tuple(y.shape) + pair, y_gen, device)

        its = method.iterations
        losses = torch.empty(its, device=device)
        probes = torch.full((its,), float("nan"), device=device)
        saved, prev_obj, stopped, steps = None, float("inf"), False, its
        stop = device_timer(device)
        for it in range(its):
            temperature = annealed_temperature(
                it, r=method.annealing_rate, ub=method.temperature_ub,
                scheme=method.annealing_scheme, t0=method.t0)
            noise = Latents(None, None)
            if draw_fn is not None:
                noise_z = draw(it, "z")
                noise = Latents(y=draw(it, "y"), z=noise_z)
            loss, _ = _loss_local(model, Latents(y, z), x_local, lmbda, num_pixels,
                                  temperature, method.name, noise, comm)
            gy, gz = torch.autograd.grad(loss, (y, z))
            # z is replicated: its gradient is the sum of every rank's part.
            gz = comm.all_reduce(gz)
            state_y = adam_update((y,), (gy,), state_y, method.lr)
            state_z = adam_update((z,), (gz,), state_z, method.lr)
            loss = comm.all_reduce(loss.detach().clone())
            if not method.early_stop:
                losses[it] = loss
                if probe_every > 0 and it % probe_every == 0:
                    probes[it] = _probe_objective(model, Latents(y, z), x_local, lmbda,
                                                  num_pixels, method.name, comm)
                continue
            if it % method.probe_interval and it != its - 1:
                continue
            obj = loss if method.name == "ste" else _probe_objective(
                model, Latents(y, z), x_local, lmbda, num_pixels, method.name, comm)
            obj = float(obj)
            if obj <= prev_obj:
                saved = Latents(y.detach().clone(), z.detach().clone())
                prev_obj = obj
            else:
                stopped, steps = True, it + 1
                break
        self.last_timing = dict(steps=steps, loop_ms=stop())
        final = saved if stopped else Latents(y.detach(), z.detach())
        q = _quantize_local(model, method.name, final.y, final.z, comm)
        metrics = _eval_transmitted(model, x_local, q, comm)
        metrics.update(y=comm.all_gather_cat(q.y, 1), z=q.z)
        if method.early_stop:
            losses = probes = torch.zeros(0)
        return dict(losses=losses.cpu().numpy(), rounded_losses=probes.cpu().numpy(),
                    **{k: v.cpu().numpy() for k, v in metrics.items()})
