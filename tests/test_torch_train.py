"""The port's Trainer against nic_tpu's, on the CPU: three optimizer steps
on the same parameters, batches and noise (MBT2018 with its two Adam
groups, with a gradient clip, and the bits-back model with its one Adam);
``steps_per_call``; a resume equal to an uninterrupted run; checkpoints
both ways (a port-written npz in nic_tpu, a nic_tpu-written npz resumed by
the port); ``init_from`` and ``init_from_partial`` against nic_tpu's;
``clip_by_global_norm`` against optax's; and the NaN and divergence guards.

Tolerances: each step's loss and metrics 1e-5 relative (float32 sums in
another order, at step 1 exactly nic_tpu's parameters); the parameters
after the steps within 2 * steps * lr of their group's learning rate, and
on average within 1e-2 * lr. Adam's first steps move a parameter by about
lr whatever its gradient's size, so where a gradient is near zero float32
rounding can send that step either way: 2 * lr per step bounds it.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nic_tpu.models.mbt2018 import MeanScaleHyperprior as JaxMBT
from nic_tpu.train.checkpoint import export_params_npz as jax_export_params_npz
from nic_tpu.train.checkpoint import load_params_npz as jax_load_params_npz
from nic_tpu.train.trainer import TrainConfig as JaxTrainConfig
from nic_tpu.train.trainer import Trainer as JaxTrainer
from nic_tpu_torch import checkpoint as ckpt_lib
from nic_tpu_torch.train.trainer import TrainConfig, Trainer, clip_by_global_norm
from train_parity import assert_rel, flat, jax_noise, jax_trainer, port_trainer

torch.set_num_threads(1)

VALUE_RTOL = 1e-5
STEPS = 3
NF, BATCH, PATCH = 8, 2, 64


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (BATCH, PATCH, PATCH, 3), dtype=np.uint8) for _ in range(n)]


def _assert_params_close(got, ref, trainer, steps):
    """Within 2 * steps * lr of each parameter's group, 1e-2 * lr on average."""
    for k, v in ref.items():
        lr = trainer.cfg.aux_lr if k.endswith("quantiles") and trainer.cfg.model == "mbt2018" \
            else trainer.cfg.main_lr
        diff = np.abs(got[k].astype(np.float64) - v)
        assert diff.max() <= 2 * steps * lr, (k, diff.max())
        assert diff.mean() <= 1e-2 * lr, (k, diff.mean())


@pytest.mark.parametrize("model,extra", [
    ("mbt2018", {}),
    ("mbt2018", {"grad_clip": 1.0}),
    ("mbt2018_bb", {}),
])
def test_steps_match_nic_tpu(model, extra):
    """3 steps of each Trainer from nic_tpu's init; ``grad_clip`` 1.0 sits
    below the gradients' global norm (~4e2 at this init), so it scales
    every step."""
    kw = dict(num_filters=NF, batchsize=BATCH, patchsize=PATCH, **extra)
    jtrainer, state = jax_trainer(model, **kw)
    trainer = port_trainer(model, flat(state.params), **kw)
    start = trainer.params_to_jax()
    for step, batch in enumerate(_batches(STEPS)):
        state, ref = jtrainer.step_fn(state, jnp.asarray(batch))
        got = trainer.run_steps(batch, jax_noise(model, state.rng, step, BATCH, PATCH, NF))
        ref = {k: float(v) for k, v in ref.items()}
        assert set(got) == set(ref)
        for k, v in ref.items():
            assert_rel(float(got[k]), v, VALUE_RTOL, f"step {step} {k}")
    assert trainer.step == int(state.step) == STEPS
    _assert_params_close(trainer.params_to_jax(), flat(state.params), trainer, STEPS)
    moved = {k: np.abs(trainer.params_to_jax()[k] - v).max() for k, v in start.items()}
    if model == "mbt2018":
        # Both Adam groups step: the quantiles at aux_lr, the rest at main_lr.
        assert 0.5 * STEPS * 1e-3 < moved["entropy_bottleneck/quantiles"] <= STEPS * 1e-3 * 1.01
        assert moved["analysis/layer_0/kernel"] <= STEPS * 1e-4 * 1.01
    else:
        assert moved["hyper_prior/quantiles"] == 0  # no gradient reaches them


def test_clip_by_global_norm_matches_optax():
    rng = np.random.default_rng(0)
    grads = [rng.normal(0, 1, s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    norm = float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2) for g in grads)))
    for max_norm in (0.5 * norm, norm, 2.0 * norm):
        params = [torch.zeros(g.shape, requires_grad=True) for g in grads]
        for p, g in zip(params, grads):
            p.grad = torch.tensor(g)
        clip_by_global_norm(params, max_norm)
        ref, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in grads], optax.EmptyState())
        for p, r in zip(params, ref):
            assert_rel(p.grad, np.asarray(r), 1e-6)
        if max_norm > norm:
            for p, g in zip(params, grads):
                assert np.array_equal(p.grad.numpy(), g)


def test_steps_per_call_equals_single_steps():
    batches = np.stack(_batches(2))
    a = port_trainer(num_filters=NF, batchsize=BATCH, patchsize=PATCH)
    b = port_trainer(num_filters=NF, batchsize=BATCH, patchsize=PATCH)
    last = a.run_steps(batches)
    for batch in batches:
        ref = b.train_step(batch)
    assert a.step == b.step == 2
    for k, v in ref.items():
        assert float(last[k]) == float(v), k
    for k, v in b.params_to_jax().items():
        assert np.array_equal(a.params_to_jax()[k], v), k


def _cfg(tmp_path, **kw):
    defaults = dict(num_filters=NF, batchsize=BATCH, patchsize=PATCH, log_every=1,
                    checkpoint_dir=str(tmp_path), save_checkpoint_secs=10_000,
                    steps_per_call=1)
    defaults.update(kw)
    return TrainConfig(**defaults)


def test_resume_equals_an_uninterrupted_run(tmp_path):
    data = _batches(4, seed=1)
    whole = Trainer(_cfg(tmp_path / "a", last_step=4), device="cpu")
    assert whole.fit(iter(data), verbose=False) == 4
    first = Trainer(_cfg(tmp_path / "b", last_step=2), device="cpu")
    first.fit(iter(data[:2]), verbose=False)
    second = Trainer(_cfg(tmp_path / "b", last_step=4), device="cpu")
    assert second.fit(iter(data[2:]), verbose=False) == 4
    assert sorted(os.listdir(second.save_dir)) == [
        "args.json", "ckpt-4.pt", "mbt2018.py", "metrics.jsonl", "params-4.npz", "record.txt"]
    for k, v in whole.params_to_jax().items():
        assert np.array_equal(second.params_to_jax()[k], v), k
    assert second.losses == whole.losses[2:] and len(whole.losses) == 4
    lines = open(os.path.join(second.save_dir, "metrics.jsonl")).read().splitlines()
    assert [ast.literal_eval(line)["step"] for line in lines] == [1, 2, 3, 4]


def test_port_npz_loads_in_nic_tpu_and_gives_the_port_forward(tmp_path):
    trainer = Trainer(_cfg(tmp_path, last_step=2), device="cpu")
    trainer.fit(iter(_batches(2)), verbose=False)
    step, params = jax_load_params_npz(os.path.join(trainer.save_dir, "params-2.npz"))
    assert step == 2
    x = np.random.default_rng(3).random((1, 64, 64, 3), dtype=np.float32)
    ref = JaxMBT(num_filters=NF).apply({"params": params}, jnp.asarray(x), training=False)
    with torch.no_grad():
        out = trainer.model(torch.tensor(x))
    for k in ("y", "z_tilde", "y_tilde", "x_tilde", "y_likelihoods", "z_likelihoods"):
        assert_rel(out[k], np.asarray(ref[k]), VALUE_RTOL, k)


def test_nic_tpu_npz_resumes_in_the_port(tmp_path):
    jtrainer, state = jax_trainer(num_filters=NF, batchsize=BATCH, patchsize=PATCH)
    trainer = Trainer(_cfg(tmp_path, last_step=9), device="cpu")
    os.makedirs(trainer.save_dir)
    jax_export_params_npz(trainer.save_dir, 7, state.params)
    assert trainer.restore_or_init() == 7
    for k, v in flat(state.params).items():
        assert np.array_equal(trainer.params_to_jax()[k], v), k
    assert trainer.fit(iter(_batches(2)), verbose=False) == 9
    # The stale-npz rule: an npz ahead of the full state is ignored.
    ckpt_lib.export_params_npz(trainer.save_dir, 20, flat(state.params))
    assert ckpt_lib.latest_params(trainer.save_dir)[0] == 9


def _printed_kept(text):
    line = [l for l in text.splitlines() if l.startswith("Warm-starting (partial)")][0]
    return sorted(ast.literal_eval(line.split("fresh: ", 1)[1]))


@pytest.mark.parametrize("partial", [False, True])
def test_init_from_takes_and_keeps_nic_tpu_leaves(tmp_path, capsys, partial):
    """A port-written mbt2018 run starts another: all of it (mbt2018), or,
    with init_from_partial, the leaves nic_tpu takes (mbt2018_bb)."""
    donor = Trainer(_cfg(tmp_path / "donor", last_step=1), device="cpu")
    donor.fit(iter(_batches(1)), verbose=False)
    model = "mbt2018_bb" if partial else "mbt2018"
    kw = dict(model=model, init_from=donor.save_dir, init_from_partial=partial)
    trainer = Trainer(_cfg(tmp_path / "port", **kw), device="cpu")
    capsys.readouterr()
    assert trainer.restore_or_init() == 0
    port_out = capsys.readouterr().out
    jtrainer = JaxTrainer(JaxTrainConfig(num_devices=1, **{
        k: v for k, v in vars(_cfg(tmp_path / "jax", **kw)).items() if k != "num_devices"}))
    jstate = jtrainer.restore_or_init()
    jax_out = capsys.readouterr().out
    got, ref, fresh = trainer.params_to_jax(), flat(jstate.params), \
        flat(jtrainer.init_state().params)
    donor_params = donor.params_to_jax()
    assert set(got) == set(ref)
    if partial:
        assert _printed_kept(port_out) == _printed_kept(jax_out)
        kept = _printed_kept(port_out)
        assert "hyper_analysis/layer_2/kernel" in kept
        assert all(k.startswith("hyper_prior/") for k in kept if k != "hyper_analysis/layer_2/kernel")
    else:
        kept = []
    for k in got:
        if k in kept:
            assert got[k].shape == fresh[k].shape
        else:
            assert np.array_equal(got[k], donor_params[k]) and np.array_equal(ref[k], got[k]), k


def test_init_from_missing_donor_fails(tmp_path):
    trainer = Trainer(_cfg(tmp_path, init_from=str(tmp_path / "nowhere")), device="cpu")
    with pytest.raises(FileNotFoundError, match="no trained checkpoint"):
        trainer.restore_or_init()


def test_init_from_another_model_needs_partial(tmp_path):
    donor = Trainer(_cfg(tmp_path / "donor", last_step=1), device="cpu")
    donor.fit(iter(_batches(1)), verbose=False)
    trainer = Trainer(_cfg(tmp_path, model="mbt2018_bb", init_from=donor.save_dir),
                      device="cpu")
    with pytest.raises(ValueError, match="init_from_partial"):
        trainer.restore_or_init()


def test_nan_and_divergence_guards_raise(tmp_path):
    trainer = Trainer(_cfg(tmp_path / "d", divergence_threshold=1e-6, last_step=3),
                      device="cpu")
    with pytest.raises(FloatingPointError, match="Diverged"):
        trainer.fit(iter(_batches(3)), verbose=False)
    trainer = Trainer(_cfg(tmp_path / "n", last_step=3), device="cpu")
    nan = np.full((BATCH, PATCH, PATCH, 3), np.nan, np.float32)
    with pytest.raises(FloatingPointError, match="NaN"):
        trainer.fit(iter([nan] * 3), verbose=False)


def test_msssim_needs_large_patches_and_multi_device_is_refused(tmp_path):
    with pytest.raises(ValueError, match="patchsize"):
        Trainer(_cfg(tmp_path, distortion="msssim"), device="cpu")
    # More ranks than the trainer's process group has (none: one rank).
    with pytest.raises(ValueError, match="needs a process group of 2 ranks"):
        Trainer(_cfg(tmp_path, num_devices=2), device="cpu")


def test_sigterm_finishes_the_step_and_saves(tmp_path):
    """SIGTERM in the middle of a run: the step in flight ends, the loop
    stops, and the run saves at that step; the previous handler returns."""
    import signal

    def data():
        for i, batch in enumerate(_batches(10)):
            if i == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch

    before = signal.getsignal(signal.SIGTERM)
    trainer = Trainer(_cfg(tmp_path, last_step=10), device="cpu")
    assert trainer.fit(data(), verbose=False) == 3
    assert ckpt_lib.latest_step(trainer.save_dir) == 3
    assert signal.getsignal(signal.SIGTERM) is before


@pytest.mark.parametrize("model", ["mbt2018", "mbt2018_bb"])
def test_logdir_runs_the_image_summaries_forward(tmp_path, model):
    """With a logdir the image summaries' evaluation forward runs on its
    cadence (here every logged step) and leaves the training noise as it is."""
    plain = Trainer(_cfg(tmp_path / "plain", model=model, last_step=2), device="cpu")
    plain.fit(iter(_batches(2)), verbose=False)
    trainer = Trainer(_cfg(tmp_path / "tb", model=model, last_step=2,
                           logdir=str(tmp_path / "logs"), save_summary_secs=0), device="cpu")
    calls = []
    forward = trainer._image_summary
    trainer._image_summary = lambda *a: calls.append(forward(*a))
    trainer.fit(iter(_batches(2)), verbose=False)
    assert len(calls) == 2 and trainer.losses == plain.losses
