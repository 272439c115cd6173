"""The ranks' side of the port's multi-rank CPU tests (``test_torch_spatial``,
``test_torch_parallel``, ``test_torch_int8``).

``nic_tpu_torch.parallel.mesh.spawn`` starts each rank in a fresh process
that imports the function it runs by module and name, so these live in a
module that imports torch and the port only: a rank never imports JAX. Each
function runs every case of its test file in one spawn (a spawn costs
seconds) and returns rank-by-rank results as numpy.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from nic_tpu_torch.infer.engine import LatentOptimizer
from nic_tpu_torch.infer.methods import DANNEAL, MAP, SGA
from nic_tpu_torch.models.layers import GDN
from nic_tpu_torch.models.mbt2018 import MeanScaleHyperprior
from nic_tpu_torch.parallel.mesh import Comm
from nic_tpu_torch.parallel.spatial import (
    SpatialLatentOptimizer,
    analyze_sharded,
    synthesize_sharded,
)

NOISE_STREAMS = {"y": 0, "z": 1, "transmit": 2}


class SeededNoise:
    """noise_fn(step, name, shape) of numpy draws seeded by (seed, step,
    name): sga's Gumbel pairs, or unoise's U(-.5, .5). It pickles, so every
    rank draws the same global tensors as one process does."""

    def __init__(self, seed: int, method: str):
        self.seed, self.method = seed, method

    def __call__(self, step, name, shape):
        rng = np.random.default_rng([self.seed, -1 if step is None else step,
                                     NOISE_STREAMS[name]])
        draw = rng.gumbel(size=shape) if self.method == "sga" else rng.uniform(
            -0.5, 0.5, size=shape)
        return torch.from_numpy(draw.astype(np.float32))


def build_model(state, dtype=torch.float32) -> MeanScaleHyperprior:
    nf = state["analysis.gdn_0.beta"].shape[0]
    model = MeanScaleHyperprior(nf)
    model.load_state_dict(state)
    if dtype != torch.float32:
        model = model.to(dtype)
        for module in model.modules():
            if hasattr(module, "dtype"):
                module.dtype = dtype
    return model


def _rank_setup(device):
    torch.set_num_threads(1)
    return dist.group.WORLD, Comm(dist.group.WORLD)


def sharded_gradients(model, y, x, w_x, w_y, comm: Comm):
    """float64: the sharded g_s's output and its input gradient against
    w_x, and the sharded g_a's output and its input gradient against w_y,
    each this rank's rows."""
    rows_y, rows_x = y.shape[1] // comm.size, x.shape[1] // comm.size
    y_local = y[:, comm.rank * rows_y:(comm.rank + 1) * rows_y].clone().requires_grad_(True)
    x_local = x[:, comm.rank * rows_x:(comm.rank + 1) * rows_x].clone().requires_grad_(True)
    xs = synthesize_sharded(model, y_local, comm).double()
    torch.sum(xs * w_x[:, comm.rank * rows_x:(comm.rank + 1) * rows_x]).backward()
    ya = analyze_sharded(model, x_local, comm).double()
    torch.sum(ya * w_y[:, comm.rank * rows_y:(comm.rank + 1) * rows_y]).backward()
    cat = comm.all_gather_cat
    return dict(g_s=cat(xs.detach(), 1).numpy(), dy=cat(y_local.grad, 1).numpy(),
                g_a=cat(ya.detach(), 1).numpy(), dx=cat(x_local.grad, 1).numpy())


def spatial_cases(rank, device, state, x, x_odd, its, grad_inputs):
    """Every spatial case of ``test_torch_spatial`` on this rank."""
    group, comm = _rank_setup(device)
    sp = SpatialLatentOptimizer(build_model(state), device, group)
    y0, z0 = sp.amortized_init(x)
    out = dict(y0=y0.numpy(), z0=z0.numpy())
    out["danneal"] = sp.optimize(x, 0.01, DANNEAL.replace(iterations=its))
    out["map"] = sp.optimize(x, 0.01, MAP.replace(iterations=10, early_stop=False))
    out["map_early_stop"] = sp.optimize(x, 0.01, MAP.replace(iterations=40))
    out["map_early_stop_steps"] = sp.last_timing["steps"]
    out["probes"] = sp.optimize(x, 0.01, DANNEAL.replace(iterations=12), probe_every=5)
    out["odd"] = sp.optimize(x_odd, 0.01, DANNEAL.replace(iterations=8))
    out["sga"] = sp.optimize(x, 0.01, SGA.replace(iterations=its), noise_fn=SeededNoise(0, "sga"))
    out["grads"] = sharded_gradients(build_model(state, torch.float64), *grad_inputs, comm)
    out["comm_calls"] = comm.calls + sp.comm.calls
    return out


def spatial_int8_cases(rank, device, state, x, its):
    """``test_torch_int8``'s spatial cases: danneal on the int8 model, and
    the sharded g_s of the int8 and the float model (and the unsharded int8
    g_s) on the transmitted y."""
    group, comm = _rank_setup(device)
    model = build_model(state)
    quant = model.clone(quant="int8")
    out = SpatialLatentOptimizer(quant, device, group).optimize(
        x, 0.01, DANNEAL.replace(iterations=its))
    y = torch.from_numpy(out["y"])
    rows = y.shape[1] // comm.size
    y_local = y[:, comm.rank * rows:(comm.rank + 1) * rows]
    with torch.no_grad():
        for name, m in (("int8", quant), ("float", model)):
            out[f"g_s_{name}_model"] = comm.all_gather_cat(
                synthesize_sharded(m, y_local, comm), 1).numpy()
        out["g_s_unsharded_int8"] = quant.synthesis(y).numpy()
    return out


def dp_inference_cases(rank, device, state, x, x_odd_batch, its):
    """Every data-parallel inference case of ``test_torch_parallel``."""
    import warnings

    group, _ = _rank_setup(device)
    opt = LatentOptimizer(build_model(state), device, group)
    out = dict(danneal=opt.optimize(x, 0.01, DANNEAL.replace(iterations=its)))
    out["sga"] = opt.optimize(x, 0.01, SGA.replace(iterations=its), noise_fn=SeededNoise(1, "sga"))
    out["sga_generator"] = opt.optimize(x, 0.01, SGA.replace(iterations=its), seed=3)
    out["map"] = opt.optimize(x, 0.01, MAP.replace(iterations=40))
    out["map_steps"] = opt.last_timing["steps"]
    out["probes"] = opt.optimize(x, 0.01, DANNEAL.replace(iterations=12), probe_every=5)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out["remainder"] = opt.optimize(x_odd_batch, 0.01, SGA.replace(iterations=its),
                                        noise_fn=SeededNoise(2, "sga"))
    out["remainder_warnings"] = [str(w.message) for w in caught]
    return out


def grads_below_bound(trainer, batch, noise):
    """The averaged gradients of each GDN's gamma off its diagonal, in one
    backward with those entries pushed below their bound (where training
    leaves most of them), so the bound's gate reads each gradient's sign;
    the parameters are put back after."""
    saved = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    gdns = {k: m for k, m in trainer.model.named_modules() if isinstance(m, GDN)}
    off = {}
    with torch.no_grad():
        for k, m in gdns.items():
            off[k] = ~torch.eye(m.gamma.shape[0], dtype=torch.bool, device=m.gamma.device)
            m.gamma[off[k]] = 0.5 * m.gamma_bound
    trainer.backward(batch, noise)
    grads = {k: m.gamma.grad[off[k]].cpu().numpy().copy() for k, m in gdns.items()}
    trainer.optimizer.zero_grad(set_to_none=True)
    trainer.model.load_state_dict(saved)
    return grads


def dp_training_cases(rank, device, cfg_kwargs, batches, noises, workdir):
    """Every data-parallel training case of ``test_torch_parallel``: the
    first step's averaged gradients, the steps' losses and parameters, the
    generator's noise, rank 0's writes, the restore check, the shrink."""
    import warnings

    from nic_tpu_torch.train.data import DeviceDataset
    from nic_tpu_torch.train.trainer import TrainConfig, Trainer

    group, comm = _rank_setup(device)
    lo, hi = comm.shard(batches[0].shape[0])
    rank_dir = os.path.join(workdir, f"rank{rank}")
    cfg = TrainConfig(checkpoint_dir=rank_dir, **cfg_kwargs)
    trainer = Trainer(cfg, device, group)
    trainer.restore_or_init()
    trainer.backward(batches[0][lo:hi], tuple(n[lo:hi] for n in noises[0]))
    grads = {k: p.grad.numpy().copy() for k, p in trainer.model.named_parameters()}
    trainer.optimizer.zero_grad(set_to_none=True)
    below = grads_below_bound(trainer, batches[0][lo:hi], tuple(n[lo:hi] for n in noises[0]))
    for b, n in zip(batches, noises):
        trainer.train_step(b[lo:hi], tuple(t[lo:hi] for t in n))
    trainer._flush_losses()
    out = dict(grads=grads, grads_below_bound=below, losses=list(trainer.losses),
               params=trainer.params_to_jax())
    # The generator's noise: drawn at the global shape, this rank's slice.
    noise = trainer.draw_noise(torch.as_tensor(batches[0][lo:hi]))
    out["generator_noise"] = [comm.all_gather_cat(t, 0).numpy() for t in noise]
    trainer.save()
    out["files"] = (sorted(os.listdir(trainer.save_dir)) if os.path.isdir(rank_dir)
                    else [])
    # Rank 1 sees no checkpoint in its own directory: the restore check raises.
    try:
        Trainer(cfg, device, group).restore_or_init()
        out["restore_error"] = None
    except RuntimeError as e:
        out["restore_error"] = str(e)
    # A batch of 3 over 2 ranks: shrinks to 1 with nic_tpu's warning; rank 1 idles.
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        shrunk = Trainer(TrainConfig(**dict(cfg_kwargs, batchsize=3, num_devices=2),
                                     checkpoint_dir=os.path.join(workdir, "shrunk")),
                         device, group)
    out["shrink_warnings"] = [str(w.message) for w in caught]
    out["shrunk_active"], out["shrunk_size"] = shrunk.active, shrunk.comm.size
    ds = DeviceDataset(os.path.join(workdir, "corpus", "*.png"), batchsize=4, patchsize=64,
                       seed=5, device=device, rank=comm.rank, world_size=comm.size)
    out["dataset"] = comm.all_gather_cat(ds.sample(2).contiguous(), 1).numpy()
    return out
