"""The trainer of the hyperprior models (counterpart of nic_tpu/train/trainer.py).

One step: the uint8 batch becomes [0, 1] floats on the device, the training
forward adds uniform noise (drawn from the trainer's device generator, or
passed in), the loss is the RD loss plus, for MBT2018, the z prior's
quantile loss; one backward, an optional global-norm clip (optax's
``clip_by_global_norm``, over every gradient), and Adam. MBT2018 trains
two Adam groups: the model at ``main_lr`` and the quantiles at ``aux_lr``
(the two losses touch disjoint parameters, so one backward serves both);
the bits-back model one Adam over everything.

``fit`` runs to ``last_step`` and resumes: a full state ``ckpt-<step>.pt``
(model, Adam, step, generator) and nic_tpu's ``params-<step>.npz`` are
written every ``save_checkpoint_secs`` and at the end, the newest of each
kept. It logs ``metrics.jsonl`` every ``log_every`` steps, with the NaN guard
and the divergence threshold read there; SIGTERM finishes the step and
saves. ``restore_or_init`` takes, in order: the run's full state; else its
npz with a fresh optimizer; else ``init_from`` (another run's parameters,
all or, with ``init_from_partial``, those whose key and shape match); else
a fresh init. Every GDN and IGDN runs K1 on the card (``ops/gdn_cuda.py``);
their backward, ``gdn_backward``, returns dx, dgamma and dbeta from torch
matmuls, as nic_tpu's is XLA.

Data parallelism (nic_tpu's data mesh): given a process group, each rank
trains on its slice of the global batch. ``num_devices`` (default: the
group's ranks) shrinks to a divisor of the batch size, with nic_tpu's
warning, and the ranks beyond it idle. After the backward the gradients are
averaged over the ranks by one flat ``all_reduce`` (not
``DistributedDataParallel``: the step's gradients are complete only after
the one backward, and a single reduction leaves the clip and Adam as they
are), so every rank takes the same step. GDN's beta and gamma are averaged
earlier, inside the backward (``GDN.average_grad``): their bounds pass a
gradient by its sign, and nic_tpu's gate reads the global batch's gradient,
where a rank's part may have the other sign (parameters at their bound).
The noise is drawn at the global batch's shape from the generator every
rank shares and each rank keeps its images' draws. The logged metrics, the NaN guard, the divergence threshold
and the clip act on reduced values; rank 0 alone writes checkpoints,
``metrics.jsonl`` and the run's metadata; a resume checks that every rank
restored the same step.
"""

import datetime
import inspect
import json
import os
import shutil
import signal
import threading
import time
import warnings
from dataclasses import asdict, dataclass
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from nic_tpu_torch import checkpoint as ckpt_lib
from nic_tpu_torch.config import resolve_device, set_fp32_precision
from nic_tpu_torch.infer.engine import device_timer
from nic_tpu_torch.models.layers import GDN, init_parameters
from nic_tpu_torch.models.mbt2018 import MeanScaleHyperprior, rd_loss
from nic_tpu_torch.models.mbt2018_bb import BitsBackHyperprior, bb_rd_loss
from nic_tpu_torch.ops.quantize import draw_uniform
from nic_tpu_torch.parallel.mesh import Comm
from nic_tpu_torch.train.data import DeviceDataset
from nic_tpu_torch.train.summaries import SummaryWriter, ThroughputMeter
from nic_tpu_torch.utils import get_runname

# The first steps of a fit (at most this many, and at most half of them)
# are left out of its ms/step: first launches and cuDNN's algorithm choice.
WARMUP_STEPS = 10


@dataclass
class TrainConfig:
    """nic_tpu's training configuration, field for field."""

    model: str = "mbt2018"  # or "mbt2018_bb"
    num_filters: int = 192
    lmbda: float = 0.01
    # "mse" (255^2 * MSE) or "msssim" (1 - MS-SSIM; patchsize >= 176).
    distortion: str = "mse"
    batchsize: int = 8
    patchsize: int = 256
    last_step: int = 1_000_000
    main_lr: float = 1e-4
    aux_lr: float = 1e-3
    # Global-norm gradient clip over every gradient (0 = off).
    grad_clip: float = 0.0
    # Absolute ceiling of the logged loss (0 = off): crossing it raises
    # FloatingPointError, as a NaN does.
    divergence_threshold: float = 0.0
    seed: int = 0
    checkpoint_dir: str = "./checkpoints"
    runname: Optional[str] = None
    save_checkpoint_secs: int = 300
    save_summary_secs: int = 60
    log_every: int = 100
    logdir: str = ""
    # Ranks of a data-parallel run (default: all of the trainer's group),
    # shrunk to a divisor of the batch size.
    num_devices: Optional[int] = None
    # Another run's checkpoint directory whose parameters start this run
    # (fresh optimizer, step 0); ignored once this run has a checkpoint.
    init_from: str = ""
    # With init_from: take only the parameters whose key and shape match
    # (e.g. mbt2018_bb from mbt2018), the rest freshly initialized.
    init_from_partial: bool = False
    # Steps per call of the fit loop, each call's batches fetched together;
    # the call's last step gives the logged metrics.
    steps_per_call: int = 1

    def resolved_runname(self) -> str:
        if self.runname:
            return self.runname
        keys = ["num_filters", "num_hfilters", "lmbda"]
        d = dict(num_filters=self.num_filters, num_hfilters=-1, lmbda=self.lmbda)
        if self.distortion != "mse":
            keys.append("distortion")
            d["distortion"] = self.distortion
        return get_runname(d, record_keys=tuple(keys), prefix=self.model)


def _stream_seed(seed: int, stream: int) -> int:
    """A seed of its own for each random stream (0: init, 1: training noise)."""
    return int(np.random.SeedSequence([seed, stream]).generate_state(1)[0])


def is_aux_param(name: str) -> bool:
    return name.split(".")[-1] == "quantiles"


def make_optimizer(model: torch.nn.Module, main_lr: float, aux_lr: float,
                   dual: bool) -> torch.optim.Adam:
    """Adam(main_lr) on the model's parameters, and with ``dual`` a second
    group, Adam(aux_lr), on the quantiles."""
    if not dual:
        return torch.optim.Adam(model.parameters(), lr=main_lr)
    named = list(model.named_parameters())
    return torch.optim.Adam([
        {"params": [p for n, p in named if not is_aux_param(n)], "lr": main_lr},
        {"params": [p for n, p in named if is_aux_param(n)], "lr": aux_lr},
    ])


@torch.no_grad()
def clip_by_global_norm(params: Iterable[torch.Tensor], max_norm: float) -> None:
    """optax's clip_by_global_norm on the gradients, in place: each becomes
    g / ||g|| * max_norm when the global norm ||g|| >= max_norm, and is left
    as it is otherwise. Makes no host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(torch.stack([torch.sum(torch.square(g)) for g in grads]).sum())
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def data_parallel_ranks(cfg: TrainConfig, world: int) -> int:
    """nic_tpu's mesh rule: the ranks asked for (default: all), at most the
    batch size and a divisor of it; warns when that idles some."""
    requested = cfg.num_devices or world
    n = min(requested, cfg.batchsize)
    while cfg.batchsize % n:
        n -= 1
    if n < requested:
        warnings.warn(
            f"data mesh shrunk from {requested} to {n} device(s) so the batch size "
            f"{cfg.batchsize} divides evenly; {requested - n} device(s) will idle. "
            f"Pick a batchsize divisible by {requested} to use the full mesh.",
            stacklevel=3,
        )
    if n > world:
        raise ValueError(
            f"num_devices={n} needs a process group of {n} ranks, one process each; "
            f"this trainer has {world} (parallel.mesh.spawn, or train's "
            "--coordinator_address/--num_processes/--process_id)")
    return n


class Trainer:
    """Owns the model, the optimizer, the noise generator, the checkpoints
    and the fit loop, on ``device``: the card unless "cpu" is asked for.
    With a process ``group``, one of its data-parallel ranks (see the
    module's docstring); every rank of the group constructs its trainer."""

    def __init__(self, cfg: TrainConfig, device="cuda", group=None):
        if cfg.distortion == "msssim" and cfg.patchsize < 176:
            raise ValueError(
                "MS-SSIM training needs patchsize >= 176 (5 scales x 11-tap "
                f"window); got {cfg.patchsize}"
            )
        world = Comm(group)
        n = data_parallel_ranks(cfg, world.size)
        if n < world.size:
            # The first n ranks train; the others idle (their fit() returns).
            group = torch.distributed.new_group(list(range(n))) if n > 1 else None
        self.active = world.rank < n
        self.comm = Comm(group if self.active else None)
        self.is_writer = world.rank == 0
        if cfg.model == "mbt2018":
            self._model_cls, self._loss_fn, self._dual = MeanScaleHyperprior, rd_loss, True
        elif cfg.model == "mbt2018_bb":
            self._model_cls, self._loss_fn, self._dual = BitsBackHyperprior, bb_rd_loss, False
        else:
            raise ValueError(f"Unknown model {cfg.model!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        set_fp32_precision()
        self.save_dir = os.path.join(cfg.checkpoint_dir, cfg.resolved_runname())
        # Every step's RD loss of the last fit, and its timing.
        self.losses: List[float] = []
        self.last_timing: Dict[str, float] = {}
        self._pending_losses: List[torch.Tensor] = []
        self.init_state()

    # ------------------------------------------------------------------ state

    def init_state(self) -> None:
        """Fresh parameters (drawn on the host from the seed, so that every
        device starts from the same ones), optimizer, step 0 and generator."""
        init_generator = torch.Generator().manual_seed(_stream_seed(self.cfg.seed, 0))
        model = init_parameters(self._model_cls(self.cfg.num_filters), init_generator)
        self.model = model.to(self.device)
        # Gradients averaged inside the backward (see the module's docstring).
        self._averaged = set()
        if self.comm.group is not None:
            for module in model.modules():
                if isinstance(module, GDN):
                    module.average_grad = self.comm.average_grad
                    self._averaged |= {id(module.beta), id(module.gamma)}
        self.optimizer = make_optimizer(self.model, self.cfg.main_lr, self.cfg.aux_lr,
                                        self._dual)
        self.step = 0
        self.generator = torch.Generator(device=self.device).manual_seed(
            _stream_seed(self.cfg.seed, 1))

    def params_to_jax(self) -> Dict[str, np.ndarray]:
        """The model's parameters under nic_tpu's flat keys and layouts."""
        return ckpt_lib.params_to_jax(self.model.state_dict(), self.cfg.model)

    def load_params(self, flat: Dict[str, np.ndarray]) -> None:
        """Load nic_tpu's flat parameters into the model (in place, so the
        optimizer keeps its parameters)."""
        self.model.load_state_dict(ckpt_lib.params_from_jax(flat, self.cfg.model))

    def state_dict(self) -> Dict:
        return dict(model_name=self.cfg.model, step=self.step,
                    model={k: v.cpu() for k, v in self.model.state_dict().items()},
                    optimizer=self.optimizer.state_dict(),
                    generator=self.generator.get_state(),
                    generator_device=self.device.type)

    def load_state_dict(self, state: Dict) -> None:
        if state["model_name"] != self.cfg.model:
            raise ValueError(f"a {state['model_name']} checkpoint, not {self.cfg.model}")
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        if state["generator_device"] == self.device.type:
            self.generator.set_state(state["generator"])
        else:
            # Another device type's generator state does not fit this one.
            self.generator.manual_seed(_stream_seed(self.cfg.seed, 1 + self.step))
            print(f"restore: the checkpoint's noise generator is a "
                  f"{state['generator_device']} one; reseeded on {self.device.type}")

    def restore_or_init(self) -> int:
        """Resume or start, in nic_tpu's order (see the module's docstring).
        Returns the step."""
        self.init_state()
        full = ckpt_lib.latest_step(self.save_dir)
        npz = ckpt_lib.latest_npz(self.save_dir)
        if full is None and npz is None and self.cfg.init_from:
            self._warm_start()
        if full is not None:
            self.load_state_dict(ckpt_lib.restore_checkpoint(self.save_dir, full))
        elif npz is not None:
            # Only the npz archive: trained parameters at its step, a fresh
            # optimizer.
            step, flat = ckpt_lib.load_params_npz(npz)
            print(f"Resuming params (fresh optimizer) from {npz}")
            self.load_params(flat)
            self.step = step
        if self.comm.group is not None:
            # Only rank 0 saves: a rank that does not see its directory
            # would start afresh while the others resume.
            steps = [int(t) for t in self.comm.all_gather(
                torch.tensor([self.step], device=self.device))]
            if min(steps) != max(steps):
                raise RuntimeError(
                    f"Checkpoint restore diverged across ranks (restored steps per rank: "
                    f"{steps}). All ranks must see the same checkpoint directory "
                    "(shared filesystem) to resume a multi-rank run.")
        return self.step

    def _warm_start(self) -> None:
        cfg = self.cfg
        donor_dir = os.path.abspath(cfg.init_from)
        full = ckpt_lib.latest_step(donor_dir)
        if full is not None:
            state = ckpt_lib.restore_checkpoint(donor_dir, full)
            step, donor = full, ckpt_lib.params_to_jax(state["model"], state["model_name"])
        else:
            npz = ckpt_lib.latest_npz(donor_dir)
            if npz is None:
                raise FileNotFoundError(f"--init_from {cfg.init_from}: no trained checkpoint")
            step, donor = ckpt_lib.load_params_npz(npz)
        fresh = self.params_to_jax()
        if cfg.init_from_partial:
            taken, kept, merged = [], [], {}
            for k, v in fresh.items():
                d = donor.get(k)
                if d is not None and d.shape == v.shape:
                    merged[k] = d.astype(v.dtype)
                    taken.append(k)
                else:
                    merged[k] = v
                    kept.append(k)
            print(f"Warm-starting (partial) from {cfg.init_from} (step {step}): "
                  f"{len(taken)} leaves transferred, {len(kept)} fresh: {kept}")
        else:
            if set(donor) != set(fresh) or any(donor[k].shape != v.shape
                                               for k, v in fresh.items()):
                raise ValueError(f"--init_from shape mismatch: {cfg.init_from} does not "
                                 f"hold a {cfg.model} parameter set of this size (use "
                                 "init_from_partial for cross-model transfer)")
            merged = donor
            print(f"Warm-starting params from {cfg.init_from} (step {step})")
        self.load_params(merged)

    # ------------------------------------------------------------------- step

    def loss(self, x, noise=None):
        """The training objective on float [B, P, P, 3] images: (the loss to
        differentiate, the metrics). ``noise`` as in ``train_step``."""
        cfg = self.cfg
        if cfg.model == "mbt2018":
            out = self.model(x, training=True, noise=noise, generator=self.generator)
        else:
            eps, noise_y = noise if noise is not None else (None, None)
            out = self.model(x, eps, training=True, noise=noise_y, generator=self.generator)
        loss, metrics = self._loss_fn(out, x, cfg.lmbda, cfg.distortion)
        if self._dual:
            aux = self.model.aux_loss()
            metrics = dict(metrics, aux_loss=aux)
            loss = loss + aux
        return loss, metrics

    def draw_noise(self, x):
        """The forward's draws for this rank's batch x from the generator:
        (z's, y's) uniform noise for MBT2018, (eps, y's) for the bits-back
        model, in the model's own order, drawn at the global batch's shape;
        this rank's images' draws."""
        b, h, w = x.shape[:3]
        lo, hi = self.comm.shard(b * self.comm.size)
        rows, cols = -(-h // 16), -(-w // 16)
        nf = self.cfg.num_filters
        z_shape = (b * self.comm.size, -(-rows // 4), -(-cols // 4), nf)
        y_shape = (b * self.comm.size, rows, cols, nf)
        if self.cfg.model == "mbt2018":
            first = draw_uniform(z_shape, self.generator, self.device)
        else:
            first = torch.randn(z_shape, generator=self.generator, device=self.device)
        return first[lo:hi], draw_uniform(y_shape, self.generator, self.device)[lo:hi]

    def backward(self, batch, noise=None) -> Dict[str, torch.Tensor]:
        """The forward and backward of a step on this rank's [B, P, P, 3]
        batch (uint8, scaled to [0, 1] here, or float), and the gradients'
        average over the ranks; leaves them in the parameters' ``grad``.
        ``noise`` is the forward's draws for this batch (see ``draw_noise``,
        which gives them when None). Returns the step's metrics as device
        scalars, this rank's (``loss`` is the RD loss, before the quantile
        loss)."""
        x = torch.as_tensor(batch).to(self.device, non_blocking=True)
        if x.dtype == torch.uint8:
            x = x.float() / 255.0
        if noise is None:
            noise = self.draw_noise(x)
        noise = tuple(n.to(self.device) for n in noise)
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.loss(x, noise)
        loss.backward()
        if self.comm.group is not None:
            # The same graph on every rank: the same parameters have gradients.
            params = [p for p in self.model.parameters()
                      if p.grad is not None and id(p) not in self._averaged]
            flat = self.comm.all_reduce(torch.cat([p.grad.reshape(-1) for p in params]))
            flat /= self.comm.size
            offset = 0
            for p in params:
                p.grad.copy_(flat[offset:offset + p.numel()].view_as(p))
                offset += p.numel()
        return metrics

    def train_step(self, batch, noise=None) -> Dict[str, torch.Tensor]:
        """One optimizer step: ``backward``, the clip, Adam. Returns the
        step's metrics (see ``backward``)."""
        metrics = self.backward(batch, noise)
        if self.cfg.grad_clip > 0:
            clip_by_global_norm(self.model.parameters(), self.cfg.grad_clip)
        self.optimizer.step()
        self.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        self._pending_losses.append(metrics["loss"])
        return metrics

    def run_steps(self, batches, noises=None) -> Dict[str, torch.Tensor]:
        """One call of the fit loop: a [B, P, P, 3] batch is one step, a
        [k, B, P, P, 3] stack k steps (``noises`` then one entry per step).
        Returns the last step's metrics."""
        batches = torch.as_tensor(batches)
        if batches.dim() == 4:
            return self.train_step(batches, noises)
        if noises is None:
            noises = [None] * len(batches)
        batches = batches.to(self.device, non_blocking=True)
        for batch, noise in zip(batches, noises):
            metrics = self.train_step(batch, noise)
        return metrics

    def reduced(self, values: torch.Tensor) -> torch.Tensor:
        """The mean over the ranks of this rank's values (the global batch's
        mean of a per-batch mean)."""
        if self.comm.group is None:
            return values
        return self.comm.all_reduce(values.clone()) / self.comm.size

    def _flush_losses(self) -> None:
        if self._pending_losses:
            self.losses.extend(self.reduced(torch.stack(self._pending_losses)).tolist())
            self._pending_losses = []

    # -------------------------------------------------------------------- fit

    def save(self) -> None:
        """The full state and the npz at this step; earlier ones are removed.
        Rank 0's job: on the other ranks a no-op."""
        if not self.is_writer:
            return
        os.makedirs(self.save_dir, exist_ok=True)
        ckpt_lib.save_checkpoint(self.save_dir, self.step, self.state_dict())
        prev = ckpt_lib.latest_npz(self.save_dir)
        path = ckpt_lib.export_params_npz(self.save_dir, self.step, self.params_to_jax())
        if prev is not None and prev != path:
            os.remove(prev)
        for name in os.listdir(self.save_dir):
            if name.startswith("ckpt-") and name != f"ckpt-{self.step}.pt":
                os.remove(os.path.join(self.save_dir, name))

    def _write_metadata(self) -> None:
        os.makedirs(self.save_dir, exist_ok=True)
        args = asdict(self.cfg)
        with open(os.path.join(self.save_dir, "record.txt"), "a") as f:
            f.write(datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S") + "\n")
            f.write(json.dumps(args, indent=4, sort_keys=True) + "\n\n")
        with open(os.path.join(self.save_dir, "args.json"), "w") as f:
            json.dump(args, f, indent=4, sort_keys=True)
        # The model's source beside the checkpoints.
        src = inspect.getsourcefile(type(self.model))
        if src:
            shutil.copy(src, self.save_dir)

    def _image_summary(self, writer: SummaryWriter, batches) -> None:
        """The original and its reconstruction by the evaluation forward."""
        img = torch.as_tensor(batches[-1] if batches.dim() == 5 else batches)
        x = img.to(self.device)
        if x.dtype == torch.uint8:
            x = x.float() / 255.0
        with torch.no_grad():
            if self.cfg.model == "mbt2018":
                out = self.model(x)
            else:
                # A generator of its own, so the training noise stays as it is.
                gen = torch.Generator(device=self.device).manual_seed(self.step)
                out = self.model(x, generator=gen)
        writer.write_images(self.step, {"original": x.cpu().numpy(),
                                        "reconstruction": out["x_tilde"].cpu().numpy()})

    def fit(self, data, verbose: bool = True, resume: bool = True) -> int:
        """Train up to cfg.last_step from the restored state (``resume``) or
        from the trainer's current one. ``data`` is a ``DeviceDataset`` or an
        iterator of [B, P, P, 3] batches. Returns the step reached."""
        cfg = self.cfg
        if not self.active:
            return self.step
        if resume:
            self.restore_or_init()
        writer = None
        if self.is_writer:
            self._write_metadata()
            writer = SummaryWriter(
                os.path.join(self.save_dir, "metrics.jsonl"),
                logdir=os.path.join(cfg.logdir, cfg.resolved_runname()) if cfg.logdir else None,
            )
        meter = ThroughputMeter()
        last_ckpt = time.time()
        last_log = 0.0
        last_image_summary = time.time()
        k = cfg.steps_per_call
        on_device = isinstance(data, DeviceDataset)
        first = self.step
        warmup = min(WARMUP_STEPS, (cfg.last_step - first) // 2)
        self.losses, self._pending_losses = [], []
        stop_timer, timed_from = None, self.step

        # SIGTERM: finish the call in flight, then save below (main thread only).
        stop_requested = threading.Event()
        prev_handler = None
        if threading.current_thread() is threading.main_thread():
            prev_handler = signal.signal(signal.SIGTERM, lambda *_: stop_requested.set())
        try:
            while self.step < cfg.last_step and not stop_requested.is_set():
                # Never past last_step: the last call shrinks to the remainder.
                this = min(k, cfg.last_step - self.step)
                if on_device:
                    batches = data.sample(this) if k > 1 else data.sample(1)[0]
                elif k == 1:
                    batches = next(data)
                else:
                    batches = np.stack([next(data) for _ in range(this)])
                batches = torch.as_tensor(batches)
                if stop_timer is None and self.step - first >= warmup:
                    stop_timer, timed_from = device_timer(self.device), self.step
                metrics = self.run_steps(batches)
                meter.update(cfg.batchsize * this, steps=this)
                if self.step % cfg.log_every == 0 or self.step == cfg.last_step:
                    names = list(metrics)
                    values = self.reduced(torch.stack([metrics[n] for n in names])).tolist()
                    metrics = dict(zip(names, values))
                    self._flush_losses()
                    loss = metrics["loss"]
                    if not (loss == loss and abs(loss) != float("inf")):
                        raise FloatingPointError(f"NaN/Inf loss at step {self.step}")
                    if 0 < cfg.divergence_threshold < loss:
                        raise FloatingPointError(
                            f"Diverged: loss {loss:.4g} > threshold "
                            f"{cfg.divergence_threshold:g} at step {self.step}")
                    now = time.time()
                    rates = meter.rates()
                    if not self.is_writer:
                        continue
                    if verbose and now - last_log >= 1.0:
                        last_log = now
                        print(f"step={self.step} loss={loss:.4f} bpp={metrics['bpp']:.4f} "
                              f"mse={metrics['mse']:.3f} "
                              f"({rates['images_per_sec']:.1f} img/s)")
                    writer.write(self.step, {**metrics, **rates})
                    if cfg.logdir and now - last_image_summary >= cfg.save_summary_secs:
                        self._image_summary(writer, batches)
                        last_image_summary = now
                    if now - last_ckpt >= cfg.save_checkpoint_secs:
                        self.save()
                        last_ckpt = now
            loop_ms = stop_timer() if stop_timer is not None else 0.0
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
            if writer is not None:
                writer.close()
        if stop_requested.is_set() and verbose:
            print(f"SIGTERM: stopping at step {self.step}; saving checkpoint.")
        self._flush_losses()
        self.last_timing = dict(steps=self.step - first, timed_steps=self.step - timed_from,
                                loop_ms=loop_ms)
        self.save()
        return self.step
