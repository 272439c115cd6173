"""The port's TensorBoard summaries and ``learned_prior --plot``, on the CPU,
against nic_tpu's.

- The same metrics and images go through nic_tpu's ``SummaryWriter``
  (tensorflow's writer) and the port's (``torch.utils.tensorboard``); both
  event files are read with tensorboard's ``EventAccumulator``, which reads
  the port's legacy scalars and nic_tpu's tensor scalars alike: the scalar
  tags, steps and float32 values are equal; the image tags, steps and shapes
  are equal and the pixels within one uint8 level (both convert as
  ``tf.image.convert_image_dtype`` does: measured equal).
- ``mbt2018 train --logdir`` at nf=8 for 2 steps writes events under
  nic_tpu's scalar and image tags, which nic_tpu's trainer writes too.
- Without the tensorboard package the writer keeps the JSON lines only.
- The fitted-density plot's pdf grid equals nic_tpu's ``model.pdf`` on the
  same grid and parameters, evaluated in float64, within 1e-6 relative (the
  port computes in float32); ``learned_prior --plot`` writes ``fitted_density.png``; without
  matplotlib ``--plot`` fails with the import's error.
"""

import builtins
import io
import json
import os
import sys
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from tensorboard.backend.event_processing.plugin_event_accumulator import EventAccumulator
from tensorboard.util.tensor_util import make_ndarray

from nic_tpu.cli.main import main as jax_cli_main
from nic_tpu.models.factorized_prior import FactorizedEntropyModel as JaxPrior
from nic_tpu.train.prior_trainer import PriorTrainConfig as JaxPriorConfig
from nic_tpu.train.prior_trainer import train_prior_cli as jax_train_prior_cli
from nic_tpu.train.summaries import SummaryWriter as JaxSummaryWriter
from nic_tpu_torch.cli.main import build_prior_parser
from nic_tpu_torch.cli.main import main as cli_main
from nic_tpu_torch.models.factorized_prior import FactorizedEntropyModel
from nic_tpu_torch.train.prior_trainer import fitted_pdf_grid, train_prior_cli
from nic_tpu_torch.train.summaries import SummaryWriter

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = "mbt2018-num_filters=8-lmbda=0.01"
PDF_RTOL = 1e-6


def read_events(logdir):
    """{tag: [(step, ndarray or list of decoded images)]} of every event
    file under logdir, scalars and images alike (read as tensors)."""
    acc = EventAccumulator(str(logdir), size_guidance={"tensors": 0})
    acc.Reload()
    out = {}
    for tag in acc.Tags()["tensors"]:
        plugin = acc.SummaryMetadata(tag).plugin_data.plugin_name
        events = []
        for ev in acc.Tensors(tag):
            value = make_ndarray(ev.tensor_proto)
            if plugin == "images":
                value = [np.asarray(Image.open(io.BytesIO(png))) for png in value[2:]]
            events.append((ev.step, value))
        out[tag] = (plugin, events)
    return out


def test_scalars_and_images_match_nic_tpus_event_file(tmp_path):
    rng = np.random.default_rng(0)
    metrics = [(3, {"loss": np.float32(1.5), "bpp": 0.25, "mse": 40.125}),
               (7, {"loss": 1.25, "bpp": np.float64(0.2), "mse": 38.0})]
    images = {"original": rng.random((3, 16, 24, 3)).astype(np.float32),
              "reconstruction": rng.normal(0.5, 0.5, (3, 16, 24, 3))}
    for side, cls in (("jax", JaxSummaryWriter), ("port", SummaryWriter)):
        writer = cls(str(tmp_path / f"{side}.jsonl"), logdir=str(tmp_path / side))
        for step, m in metrics:
            writer.write(step, m)
        writer.write_images(7, images, max_outputs=2)
    ref, got = read_events(tmp_path / "jax"), read_events(tmp_path / "port")
    assert sorted(got) == sorted(ref) == ["bpp", "loss", "mse", "original", "reconstruction"]
    for tag in ("bpp", "loss", "mse"):
        assert got[tag][0] == ref[tag][0] == "scalars"
        assert [s for s, _ in got[tag][1]] == [s for s, _ in ref[tag][1]] == [3, 7]
        for (_, a), (_, b) in zip(got[tag][1], ref[tag][1]):
            np.testing.assert_array_equal(a.astype(np.float32), b.astype(np.float32))
    for tag in ("original", "reconstruction"):
        assert got[tag][0] == ref[tag][0] == "images"
        (step, imgs), = got[tag][1]
        (ref_step, ref_imgs), = ref[tag][1]
        assert step == ref_step == 7 and len(imgs) == len(ref_imgs) == 2
        for a, b in zip(imgs, ref_imgs):
            assert a.shape == b.shape == (16, 24, 3) and a.dtype == b.dtype == np.uint8
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert open(tmp_path / "port.jsonl").read() == open(tmp_path / "jax.jsonl").read()


def test_writer_without_tensorboard_keeps_the_json_lines(tmp_path, monkeypatch):
    real_import = builtins.__import__

    def no_tensorboard(name, *args, **kwargs):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError("no tensorboard")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    writer = SummaryWriter(str(tmp_path / "m.jsonl"), logdir=str(tmp_path / "tb"))
    writer.write(1, {"loss": 2.0})
    writer.write_images(1, {"original": np.zeros((1, 4, 4, 3))})
    writer.close()
    assert not os.path.exists(tmp_path / "tb")
    assert [json.loads(x) for x in open(tmp_path / "m.jsonl")] == [{"step": 1, "loss": 2.0}]


@pytest.fixture(scope="module")
def train_corpus(tmp_path_factory):
    """Three 96x128 photo crops as PNGs."""
    d = tmp_path_factory.mktemp("summaries_corpus")
    photos = np.load(os.path.join(ROOT, "data_real", "eval_photos.npy"))
    for i in range(3):
        Image.fromarray(photos[i, 100:196, 200:328]).save(d / f"img{i}.png")
    return d


def test_train_logdir_writes_nic_tpus_tags(train_corpus, tmp_path):
    """Two steps of ``mbt2018 train --logdir`` in each package, logging every
    step and writing images at once: the same scalar and image tags."""
    common = ["--num_filters", "8", "--checkpoint_dir", None, "mbt2018", "train",
              "--train_glob", str(train_corpus / "img*.png"), "--patchsize", "64",
              "--batchsize", "2", "--last_step", "2", "--steps_per_call", "1",
              "--save_summary_secs", "0", "--logdir", None]
    tags = {}
    for side, run in (("port", lambda a: cli_main(["--device", "cpu"] + a)),
                      ("jax", jax_cli_main)):
        argv = list(common)
        argv[3], argv[-1] = str(tmp_path / side / "ckpt"), str(tmp_path / side / "logs")
        run(argv)
        events = read_events(tmp_path / side / "logs" / RUN)
        tags[side] = {tag: (plugin, [s for s, _ in ev]) for tag, (plugin, ev) in events.items()}
    assert tags["port"].keys() == tags["jax"].keys()
    assert {"loss", "bpp", "mse", "images_per_sec", "original", "reconstruction"} <= set(
        tags["port"])
    for tag, (plugin, steps) in tags["port"].items():
        assert plugin == tags["jax"][tag][0], tag
        assert steps and set(steps) <= {1, 2}, (tag, steps)


def test_pdf_grid_matches_nic_tpus_pdf():
    """The pdf that ``--plot`` draws, from the same prior parameters (nic_tpu's
    init, its biases moved so the channels differ), against nic_tpu's pdf
    evaluated in float64: its float32 evaluation is itself 5.4e-7 off (the
    port's 2.4e-7), too near the tolerance to be the reference."""
    channels = 5
    rng = np.random.default_rng(3)
    prior = JaxPrior(channels=channels, dims=(3, 3, 3), init_scale=1.0)
    params = prior.init(jax.random.PRNGKey(0), jnp.zeros((1, channels)), training=False)["params"]
    params = {k: np.asarray(v) + (rng.normal(0, 0.3, np.shape(v)).astype(np.float32)
                                  if k.startswith(("bias", "factor")) else 0)
              for k, v in params.items()}
    xs = np.linspace(-5, 5, 200).astype(np.float32)
    with jax.enable_x64(True):
        grid = jnp.tile(jnp.asarray(xs, jnp.float64)[:, None], (1, channels))
        ref = np.asarray(prior.apply({"params": {k: v.astype(np.float64) for k, v in
                                                 params.items()}}, grid, method=prior.pdf))
    model = FactorizedEntropyModel(channels, dims=(3, 3, 3), init_scale=1.0)
    model.load_state_dict({k: torch.tensor(v) for k, v in params.items()})
    got_xs, got = fitted_pdf_grid(model)
    np.testing.assert_array_equal(got_xs, xs)
    assert got.shape == ref.shape == (200, channels)
    np.testing.assert_allclose(got, ref, rtol=PDF_RTOL, atol=PDF_RTOL * np.abs(ref).max())


def _prior_argv(tmp_path, channels=10):
    data = np.random.default_rng(1).normal(0, 1.5, (200, channels)).astype(np.float32)
    np.save(tmp_path / "y.npy", data)
    return ["--num_channels", str(channels), "--data_path", str(tmp_path / "y.npy"),
            "--its", "5", "--plot"]


def test_learned_prior_plot_writes_fitted_density(tmp_path):
    """``learned_prior --plot`` through the CLI writes nic_tpu's files, the
    figure among them, a PNG of nic_tpu's size."""
    argv = _prior_argv(tmp_path)
    ours = cli_main(["learned_prior", "--device", "cpu", "--checkpoint_dir",
                     str(tmp_path / "port")] + argv)
    ref = jax_train_prior_cli(Namespace(**vars(build_prior_parser().parse_args(
        argv + ["--checkpoint_dir", str(tmp_path / "jax")]))))
    assert sorted(os.listdir(ours)) == sorted(os.listdir(ref)) == [
        "args.json", "fitted_density.png", "prior_model.npz", "record.json"]
    with Image.open(os.path.join(ours, "fitted_density.png")) as a, \
            Image.open(os.path.join(ref, "fitted_density.png")) as b:
        assert a.format == b.format == "PNG" and a.size == b.size


def test_plot_without_matplotlib_fails_with_the_import_error(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    args = build_prior_parser().parse_args(
        _prior_argv(tmp_path, 2) + ["--device", "cpu", "--checkpoint_dir", str(tmp_path)])
    with pytest.raises(ImportError, match="matplotlib"):
        train_prior_cli(args)
    run = JaxPriorConfig(num_channels=2, its=5).runname()
    assert sorted(os.listdir(tmp_path / run)) == ["args.json", "prior_model.npz"]
