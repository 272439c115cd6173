"""The port's training input, prior fitter, summaries and supervisor, on the
CPU: ``PatchPipeline`` (with one worker thread it gives nic_tpu's batches,
the same numpy streams) and ``DeviceDataset`` (crops inside the images, the
same seed giving the same batches, mixed sizes refused); the prior fitter
against nic_tpu's over k iterations from the same init, and its CLI's files
against nic_tpu's; the JSON-lines writer, the meter and the profiler trace;
the crash supervisor's retries and signal forwarding.

Tolerance of the prior fit: every logged loss 1e-5 relative (float32 sums
in another order), the parameters after it within 1e-2 * lr.
"""

import json
import os
import signal
import threading
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nic_tpu.models.factorized_prior import FactorizedEntropyModel as JaxPrior
from nic_tpu.train.data import PatchPipeline as JaxPatchPipeline
from nic_tpu.train.prior_trainer import PriorTrainConfig as JaxPriorConfig
from nic_tpu.train.prior_trainer import fit_factorized_prior as jax_fit
from nic_tpu.train.prior_trainer import train_prior_cli as jax_train_prior_cli
from nic_tpu_torch.cli.main import build_prior_parser
from nic_tpu_torch.models.factorized_prior import FactorizedEntropyModel
from nic_tpu_torch.train import supervisor
from nic_tpu_torch.train.data import DeviceDataset, PatchPipeline
from nic_tpu_torch.train.prior_trainer import (PriorTrainConfig, fit_factorized_prior,
                                               train_prior_cli)
from nic_tpu_torch.train.summaries import SummaryWriter, ThroughputMeter, profile_trace

torch.set_num_threads(1)

P = 32


def _image(i, h=80, w=96):
    """Pixel (y, x) of image i holds (y, x, 50 i): a crop says where it came from."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([yy, xx, np.full_like(yy, 50 * i)], -1).astype(np.uint8)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    for i in range(4):
        Image.fromarray(_image(i)).save(d / f"img{i}.png")
    return d


def _assert_crops_inside(batch):
    for crop in batch.reshape(-1, P, P, 3):
        y, x, i = int(crop[0, 0, 0]), int(crop[0, 0, 1]), int(crop[0, 0, 2]) // 50
        assert np.array_equal(crop, _image(i)[y:y + P, x:x + P]), (i, y, x)


def test_patch_pipeline_gives_nic_tpus_batches(corpus):
    glob = str(corpus / "*.png")
    ours = PatchPipeline(glob, batchsize=3, patchsize=P, num_threads=1, seed=5)
    ref = JaxPatchPipeline(glob, batchsize=3, patchsize=P, num_threads=1, seed=5)
    try:
        for _ in range(3):
            batch = next(ours)
            assert batch.shape == (3, P, P, 3) and batch.dtype == np.uint8
            _assert_crops_inside(batch)
            assert np.array_equal(batch, next(ref))
    finally:
        ours.close()
        ref.close()


def test_device_dataset_samples_crops_on_its_device(corpus):
    glob = str(corpus / "*.png")
    ds = DeviceDataset(glob, batchsize=3, patchsize=P, seed=5, device="cpu")
    again = DeviceDataset(glob, batchsize=3, patchsize=P, seed=5, device="cpu")
    assert ds.num_images == 4 and ds.nbytes == 4 * 80 * 96 * 3
    a, b = ds.sample(2), ds.sample(1)
    assert a.shape == (2, 3, P, P, 3) and a.dtype == torch.uint8 and a.device.type == "cpu"
    _assert_crops_inside(a.numpy())
    _assert_crops_inside(b.numpy())
    assert torch.equal(a, again.sample(2)) and not torch.equal(a[:1], b)


def test_device_dataset_refuses_mixed_sizes_and_an_empty_glob(corpus, tmp_path):
    for i, size in enumerate(((64, 64), (80, 96))):
        Image.fromarray(_image(i, *size)).save(tmp_path / f"m{i}.png")
    with pytest.raises(ValueError, match="uniformly-sized"):
        DeviceDataset(str(tmp_path / "m*.png"), batchsize=2, patchsize=P, device="cpu")
    with pytest.raises(RuntimeError, match="No training images"):
        DeviceDataset(str(tmp_path / "none*.png"), device="cpu")
    with pytest.raises(RuntimeError, match="No training images"):
        PatchPipeline(str(tmp_path / "none*.png"))


def test_prior_fit_matches_nic_tpu(tmp_path):
    """k Adam iterations from nic_tpu's init on the same samples."""
    rng = np.random.default_rng(0)
    data = np.concatenate([rng.normal(-2, 0.5, (150, 3)), rng.normal(1.5, 1.0, (150, 3))])
    data = data.astype(np.float32)
    kw = dict(num_channels=3, its=10, tol=0.0, logging_freq=1, lr=0.01)
    jparams, jrecord = jax_fit(data, JaxPriorConfig(**kw), verbose=False)
    init = JaxPrior(channels=3, dims=(3, 3, 3), init_scale=1.0).init(
        jax.random.PRNGKey(0), jnp.asarray(data[:1]), training=False)["params"]
    model = FactorizedEntropyModel(3, dims=(3, 3, 3), init_scale=1.0)
    model.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in init.items()})
    model, record = fit_factorized_prior(data, PriorTrainConfig(**kw), verbose=False,
                                         device="cpu", model=model)
    assert [r["it"] for r in record] == [r["it"] for r in jrecord] == list(range(10))
    np.testing.assert_allclose([r["loss"] for r in record], [r["loss"] for r in jrecord],
                               rtol=1e-5)
    assert record[-1]["loss"] < record[0]["loss"]
    for name, p in model.named_parameters():
        assert np.abs(p.detach().numpy() - np.asarray(jparams[name])).max() <= 1e-2 * 0.01


def test_prior_cli_writes_nic_tpus_files(tmp_path):
    rng = np.random.default_rng(1)
    np.save(tmp_path / "x.npy", rng.normal(0, 1, (100, 2)).astype(np.float32))
    argv = ["--num_channels", "2", "--data_path", str(tmp_path / "x.npy"), "--its", "5",
            "--logging_freq", "2"]
    ours = train_prior_cli(build_prior_parser().parse_args(
        argv + ["--device", "cpu", "--checkpoint_dir", str(tmp_path / "port")]))
    ref = jax_train_prior_cli(Namespace(**vars(build_prior_parser().parse_args(
        argv + ["--checkpoint_dir", str(tmp_path / "jax")]))))
    assert os.path.basename(ours) == os.path.basename(ref)
    with np.load(os.path.join(ours, "prior_model.npz")) as a, \
            np.load(os.path.join(ref, "prior_model.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[k].shape == b[k].shape for k in a.files)
    args = [json.load(open(os.path.join(d, "args.json"))) for d in (ours, ref)]
    assert {k: v for k, v in args[0].items() if k != "checkpoint_dir"} == \
        {k: v for k, v in args[1].items() if k != "checkpoint_dir"}
    assert [r["it"] for r in json.load(open(os.path.join(ours, "record.json")))] == [0, 2, 4]


def test_summary_writer_meter_and_profile_trace(tmp_path):
    writer = SummaryWriter(str(tmp_path / "metrics.jsonl"), logdir=str(tmp_path / "tb"))
    writer.write(3, {"loss": np.float32(1.5), "bpp": 0.25})
    writer.write_images(3, {"original": np.zeros((1, 4, 4, 3))})
    lines = open(tmp_path / "metrics.jsonl").read().splitlines()
    assert [json.loads(line) for line in lines] == [{"step": 3, "loss": 1.5, "bpp": 0.25}]
    meter = ThroughputMeter()
    meter.update(8, steps=2)
    rates = meter.rates()
    assert rates["images_per_sec"] == pytest.approx(4 * rates["steps_per_sec"])
    with profile_trace(str(tmp_path / "trace")):
        torch.ones(3).sum()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    with profile_trace(""):
        pass


class _Proc:
    """A stand-in child process: exit codes in order, recording its command."""

    def __init__(self, codes, calls):
        self.codes, self.calls = codes, calls

    def __call__(self, cmd, env=None):
        self.calls.append((cmd, env))
        self.code = self.codes[len(self.calls) - 1]
        return self

    def wait(self):
        return self.code

    def poll(self):
        return self.code


def test_supervisor_retries_until_success(monkeypatch):
    calls = []
    monkeypatch.setattr(supervisor.subprocess, "Popen", _Proc([1, 1, 0], calls))
    assert supervisor.supervise(["mbt2018", "train"], retries=3, backoff_secs=0.0) == 0
    assert len(calls) == 3
    cmd, env = calls[0]
    assert cmd[1:] == ["-m", "nic_tpu_torch", "mbt2018", "train"]
    assert env["NIC_TPU_TORCH_TRAIN_CHILD"] == "1"
    calls.clear()
    monkeypatch.setattr(supervisor.subprocess, "Popen", _Proc([7, 7], calls))
    assert supervisor.supervise(["x"], retries=1, backoff_secs=0.0) == 7 and len(calls) == 2


def test_supervisor_forwards_sigterm_and_stops(monkeypatch):
    terminated = threading.Event()

    class Child:
        def __init__(self, cmd, env=None):
            pass

        def wait(self):
            os.kill(os.getpid(), signal.SIGTERM)
            return -15 if terminated.is_set() else 0

        def poll(self):
            return None

        def terminate(self):
            terminated.set()

    monkeypatch.setattr(supervisor.subprocess, "Popen", Child)
    assert supervisor.supervise(["x"], retries=3, backoff_secs=0.0) == 143
    assert terminated.is_set()
    assert signal.getsignal(signal.SIGTERM) is not supervisor.supervise
