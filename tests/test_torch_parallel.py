"""The port's data-parallel inference and training, its process groups and
its multi-host training, on the CPU with gloo ranks.

- Inference (``LatentOptimizer(model, device, group)``), 2 ranks: danneal
  against nic_tpu's ``LatentOptimizer(mesh=data_mesh(2))``; SGA with
  injected noise and with the shared generator, map's early stop and the
  --verbose probes against the port's unsharded engine; a batch the ranks
  do not divide runs whole, with nic_tpu's warning.
- Training (``Trainer(cfg, device, group)``), 2 ranks against 1: the first
  step's averaged gradients, three steps' losses and parameters, the
  generator's noise, rank 0's writes, the restore check, nic_tpu's shrink
  rule, and ``DeviceDataset``'s slices.
- ``train --coordinator_address/--num_processes/--process_id``: two
  processes train two steps and agree (after nic_tpu's
  ``tests/test_multihost.py``).

Each group of cases runs in one spawn (``torch_dist_workers``).

Tolerances: against the unsharded engine with injected noise, y equal and
bpp within 1e-6 (the same per-image arithmetic; the loss's sums are
reduced over ranks); against nic_tpu, at least 99.9 % of y equal and bpp
and PSNR within 1e-3 (float32 through Adam, nic_tpu's spatial tests'
tolerance). Training: each leaf's averaged gradient within 1e-5 of its
norm (the batch mean summed in another order), losses within 1e-5, the
parameters within 2 * steps * lr (Adam's first steps move a parameter by
about lr whatever its gradient: a fresh GDN's off-diagonal gammas sit at
their bound with gradients near zero, whose sign float32 rounding decides),
and every rank's parameters equal.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from PIL import Image

from nic_tpu.infer.engine import LatentOptimizer as JaxLatentOptimizer
from nic_tpu.infer.methods import DANNEAL as JAX_DANNEAL
from nic_tpu.models.mbt2018 import MeanScaleHyperprior as JaxMBT
from nic_tpu.parallel.mesh import data_mesh
from nic_tpu_torch.checkpoint import params_from_jax
from nic_tpu_torch.infer.engine import LatentOptimizer
from nic_tpu_torch.infer.methods import MAP, SGA
from nic_tpu_torch.parallel import mesh
from nic_tpu_torch.train.data import DeviceDataset
from nic_tpu_torch.train.trainer import TrainConfig, Trainer
from torch_dist_workers import (
    SeededNoise,
    build_model,
    dp_inference_cases,
    dp_training_cases,
    grads_below_bound,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NF = 8
ITS = 20
RANKS = 2
BPP_RTOL = 1e-6
Y_EQUAL = 0.999
METRIC_RTOL = 1e-3
GRAD_RTOL = 1e-5
LOSS_RTOL = 1e-5
STEPS = 3
TRAIN = dict(model="mbt2018", num_filters=NF, batchsize=4, patchsize=64)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jmodel = JaxMBT(num_filters=NF)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), training=True,
                         rng=jax.random.PRNGKey(1))["params"]
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}
    rng = np.random.default_rng(0)
    workdir = tmp_path_factory.mktemp("parallel")
    corpus = workdir / "corpus"
    corpus.mkdir()
    photos = np.load(os.path.join(ROOT, "data_real", "eval_photos.npy"))
    for i in range(3):
        Image.fromarray(photos[i, 100:196, 200:328]).save(corpus / f"img{i}.png")
    batches = [rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8) for _ in range(STEPS)]
    noises = [(torch.from_numpy(rng.uniform(-0.5, 0.5, (4, 1, 1, NF)).astype(np.float32)),
               torch.from_numpy(rng.uniform(-0.5, 0.5, (4, 4, 4, NF)).astype(np.float32)))
              for _ in range(STEPS)]
    return dict(jmodel=jmodel, params=params, state=params_from_jax(flat),
                x=rng.random((4, 64, 64, 3), np.float32),
                x_odd=rng.random((3, 64, 64, 3), np.float32),
                batches=batches, noises=noises, workdir=workdir)


@pytest.fixture(scope="module")
def inference(setup):
    return mesh.spawn(dp_inference_cases, RANKS,
                      (setup["state"], setup["x"], setup["x_odd"], ITS), device="cpu")


@pytest.fixture(scope="module")
def training(setup):
    s = setup
    return mesh.spawn(dp_training_cases, RANKS,
                      (TRAIN, s["batches"], s["noises"], str(s["workdir"])), device="cpu")


@pytest.fixture(scope="module")
def unsharded(setup):
    return LatentOptimizer(build_model(setup["state"]), "cpu")


def _assert_same_run(got, ref):
    np.testing.assert_array_equal(got["y"], ref["y"])
    np.testing.assert_array_equal(got["z"], ref["z"])
    np.testing.assert_allclose(got["est_bpp"], ref["est_bpp"], rtol=BPP_RTOL)
    np.testing.assert_allclose(got["psnr"], ref["psnr"], rtol=BPP_RTOL)


# ---------------------------------------------------------------- inference


def test_dp_danneal_matches_nic_tpu_on_data_mesh(inference, setup):
    ref = JaxLatentOptimizer(setup["jmodel"], setup["params"], mesh=data_mesh(RANKS)).optimize(
        setup["x"], 0.01, method=JAX_DANNEAL.replace(iterations=ITS))
    got = inference[0]["danneal"]
    assert got["y"].shape == ref["y"].shape
    assert np.mean(got["y"] == np.asarray(ref["y"])) >= Y_EQUAL
    for k in ("est_bpp", "psnr", "mse"):
        np.testing.assert_allclose(got[k], ref[k], rtol=METRIC_RTOL, err_msg=k)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=METRIC_RTOL)


@pytest.mark.parametrize("case,kwargs", [
    ("sga", dict(noise_fn=SeededNoise(1, "sga"))),
    ("sga_generator", dict(seed=3)),
])
def test_dp_sga_equals_the_unsharded_engine(inference, unsharded, setup, case, kwargs):
    """Each rank keeps its images' draws of the global noise (injected, or
    from the generator every rank shares): the unsharded run's latents."""
    ref = unsharded.optimize(setup["x"], 0.01, SGA.replace(iterations=ITS), **kwargs)
    got = inference[0][case]
    _assert_same_run(got, ref)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=BPP_RTOL)
    for other in inference[1:]:
        _assert_same_run(other[case], got)


def test_dp_map_early_stop_and_probes_follow_the_global_objective(inference, unsharded, setup):
    ref = unsharded.optimize(setup["x"], 0.01, MAP.replace(iterations=40))
    assert inference[0]["map_steps"] == unsharded.last_timing["steps"]
    np.testing.assert_allclose(inference[0]["map"]["y"], ref["y"], atol=1e-4)
    from nic_tpu_torch.infer.methods import DANNEAL

    ref = unsharded.optimize(setup["x"], 0.01, DANNEAL.replace(iterations=12), probe_every=5)
    got = inference[0]["probes"]["rounded_losses"]
    mask = np.isfinite(got)
    np.testing.assert_array_equal(mask, np.isfinite(ref["rounded_losses"]))
    np.testing.assert_allclose(got[mask], ref["rounded_losses"][mask], rtol=BPP_RTOL)


def test_dp_remainder_batch_warns_and_runs_replicated(inference, unsharded, setup):
    warnings = inference[0]["remainder_warnings"]
    assert any("runs replicated" in w for w in warnings), warnings
    ref = unsharded.optimize(setup["x_odd"], 0.01, SGA.replace(iterations=ITS),
                             noise_fn=SeededNoise(2, "sga"))
    _assert_same_run(inference[0]["remainder"], ref)
    _assert_same_run(inference[1]["remainder"], ref)


def test_one_rank_needs_no_group_and_nccl_needs_the_card():
    comm = mesh.Comm()
    t = torch.ones(3)
    assert comm.size == 1 and comm.all_reduce(t) is t and comm.all_gather(t) == [t]
    assert comm.shard(6) == (0, 6)
    with pytest.raises(ValueError, match="NCCL needs the card"):
        mesh.init_group("file:///nonexistent", 1, 0, device="cpu", backend="nccl")
    assert mesh.default_backend("cpu") == "gloo" and mesh.default_backend("cuda") == "nccl"


def test_spawn_raises_a_rank_s_error():
    with pytest.raises(RuntimeError, match="rank 1"):
        mesh.spawn(_fail_on_rank_1, 2, device="cpu")


def _fail_on_rank_1(rank, device):
    if rank == 1:
        raise ValueError("rank 1 fails")
    return rank


# ----------------------------------------------------------------- training


@pytest.fixture(scope="module")
def one_rank(setup):
    trainer = Trainer(TrainConfig(checkpoint_dir=str(setup["workdir"] / "one"), **TRAIN), "cpu")
    trainer.restore_or_init()
    b, n = setup["batches"], setup["noises"]
    trainer.backward(b[0], n[0])
    grads = {k: p.grad.numpy().copy() for k, p in trainer.model.named_parameters()}
    trainer.optimizer.zero_grad(set_to_none=True)
    below = grads_below_bound(trainer, b[0], n[0])
    for batch, noise in zip(b, n):
        trainer.train_step(batch, noise)
    trainer._flush_losses()
    noise = trainer.draw_noise(torch.as_tensor(b[0]))
    return dict(grads=grads, grads_below_bound=below, losses=trainer.losses,
                params=trainer.params_to_jax(),
                generator_noise=[t.numpy() for t in noise], cfg=trainer.cfg)


def test_dp_training_averages_the_gradients_of_the_global_batch(training, one_rank):
    for k, ref in one_rank["grads"].items():
        got = training[0]["grads"][k]
        err = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)
        assert err <= GRAD_RTOL, (k, err)
        np.testing.assert_array_equal(training[1]["grads"][k], got)


def test_dp_training_bound_gate_reads_the_global_gradient(training, one_rank):
    """GDN's gamma below its bound passes a gradient by its sign: the global
    batch's, as in one rank (and nic_tpu), not each rank's part. Held over
    the entries below the bound, whose gradients are ~1e-5 of the leaf's."""
    for k, ref in one_rank["grads_below_bound"].items():
        got = training[0]["grads_below_bound"][k]
        err = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)
        assert err <= GRAD_RTOL, (k, err)
        np.testing.assert_array_equal(training[1]["grads_below_bound"][k], got)


def test_dp_training_steps_match_one_rank(training, one_rank):
    cfg = one_rank["cfg"]
    for r in training:
        np.testing.assert_allclose(r["losses"], one_rank["losses"], rtol=LOSS_RTOL)
    for k, ref in one_rank["params"].items():
        lr = cfg.aux_lr if k.endswith("quantiles") else cfg.main_lr
        diff = np.abs(training[0]["params"][k].astype(np.float64) - ref)
        assert diff.max() <= 2 * STEPS * lr, k
        np.testing.assert_array_equal(training[1]["params"][k], training[0]["params"][k])


def test_dp_training_noise_is_the_global_draw(training, one_rank):
    for got, ref in zip(training[0]["generator_noise"], one_rank["generator_noise"]):
        np.testing.assert_array_equal(got, ref)


def test_draw_noise_is_the_models_own_draw(setup):
    """The trainer's explicit draws are those the model makes from the
    same generator, so the unsharded step is unchanged."""
    for model in ("mbt2018", "mbt2018_bb"):
        trainer = Trainer(TrainConfig(checkpoint_dir=str(setup["workdir"] / model),
                                      **dict(TRAIN, model=model)), "cpu")
        x = torch.as_tensor(setup["batches"][0]).float() / 255.0
        state = trainer.generator.get_state()
        noise = trainer.draw_noise(x)
        with torch.no_grad():
            explicit, _ = trainer.loss(x, noise)
            trainer.generator.set_state(state)
            drawn, _ = trainer.loss(x)
        assert float(explicit) == float(drawn), model


def test_only_rank_0_writes_and_a_diverged_restore_raises(training):
    assert "ckpt-3.pt" in training[0]["files"] and "params-3.npz" in training[0]["files"]
    assert training[1]["files"] == []
    for r in training:
        assert "restore diverged across ranks" in r["restore_error"]
        assert "[3, 0]" in r["restore_error"]


def test_num_devices_shrinks_to_a_divisor_of_the_batch(training):
    warnings = training[0]["shrink_warnings"]
    assert any("shrunk from 2 to 1 device(s)" in w for w in warnings), warnings
    assert (training[0]["shrunk_active"], training[0]["shrunk_size"]) == (True, 1)
    assert training[1]["shrunk_active"] is False


def test_device_dataset_ranks_take_slices_of_the_global_batch(training, setup):
    whole = DeviceDataset(str(setup["workdir"] / "corpus" / "*.png"), batchsize=4,
                          patchsize=64, seed=5, device="cpu").sample(2).numpy()
    np.testing.assert_array_equal(training[0]["dataset"], whole)


# --------------------------------------------------------------- multi-host


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_cluster_trains_and_agrees(setup, tmp_path):
    """Two ranks through train's multi-host flags: both reach step 2 with
    the same loss and parameters, and rank 0 alone writes the run."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    ckpt = tmp_path / "ckpt"
    argv = [sys.executable, "-m", "nic_tpu_torch", "--device", "cpu", "--num_filters", str(NF),
            "--checkpoint_dir", str(ckpt), "mbt2018", "train", "--train_glob",
            str(setup["workdir"] / "corpus" / "*.png"), "--patchsize", "64", "--batchsize", "2",
            "--last_step", "2", "--steps_per_call", "1", "--coordinator_address",
            f"localhost:{port}", "--num_processes", "2"]
    procs = [subprocess.Popen(argv + ["--process_id", str(i)], cwd=ROOT, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"rank failed:\n{out}\n{err}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ends = []
    for i, out in enumerate(outs):
        lines = [line for line in out.splitlines() if line.startswith(f"rank {i} of 2:")]
        assert lines, out
        ends.append(lines[-1].split(":", 1)[1])
    assert ends[0] == ends[1] and "step 2," in ends[0]
    assert sorted(p.name for p in (ckpt / "mbt2018-num_filters=8-lmbda=0.01").iterdir()) == [
        "args.json", "ckpt-2.pt", "mbt2018.py", "metrics.jsonl", "params-2.npz", "record.txt"]
