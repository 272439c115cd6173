"""The port's ``tools/diagnose_photos.py`` and ``tools/demo.py`` against
nic_tpu's ``scripts/diagnose_photos.py`` and ``scripts/demo.py``, on the CPU
(the scripts imported with ``scripts/`` on ``sys.path``, as nic_tpu's own
tests import them, and run through their ``main``).

Tolerances:
- diagnose_photos at nf=8 (nic_tpu's init) on two photo crops that need
  padding: every field of every row and of the mean within 1e-5 relative,
  the shares at the scale bounds (sig_lo, sig_hi) exact, the record's keys,
  their order and the npz path equal;
- at nf=192, photo 0 on ``checkpoints_val2``'s lambda=0.01 run, against a
  live run of nic_tpu's script: 1e-4 relative (float32 sums over 147456
  latents in another order; measured 1.8e-6). The committed
  results/photos/diagnose_lmbda0.01.json names params-196800.npz, which
  the run no longer holds (only params-320000.npz), so nic_tpu's script no
  longer reproduces it and the live run is the reference;
- demo: ``synthetic_images`` equal bit for bit; the demo runs end to end
  with both streams decoded exactly.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from nic_tpu.models.mbt2018 import MeanScaleHyperprior as JaxMBT
from nic_tpu_torch.tools import demo, diagnose_photos

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import demo as jax_demo  # noqa: E402
import diagnose_photos as jax_diagnose_photos  # noqa: E402

torch.set_num_threads(1)

PHOTOS = os.path.join(ROOT, "data_real", "eval_photos.npy")
VAL_RUN = os.path.join("checkpoints_val2", "mbt2018-num_filters=192-lmbda=0.01")
ROW_RTOL = 1e-5
FULL_WIDTH_RTOL = 1e-4
SHARES = ("sig_lo", "sig_hi")


def _run_script(module, monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", [module.__file__] + [str(a) for a in argv])
    return module.main()


def _assert_records(got, ref, rtol):
    assert list(got) == list(ref) == ["rows", "mean", "params"]
    assert got["params"] == ref["params"]
    assert len(got["rows"]) == len(ref["rows"])
    for g, r in zip(got["rows"] + [got["mean"]], ref["rows"] + [ref["mean"]]):
        assert list(g) == list(r)
        for k, v in r.items():
            if k in SHARES or k == "image":
                assert g[k] == v, k
            else:
                np.testing.assert_allclose(g[k], v, rtol=rtol, atol=0, err_msg=k)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """nic_tpu's nf=8 init as a run (params-0.npz, args.json), and two
    70x90 photo crops (padded to 128x128 by both)."""
    d = tmp_path_factory.mktemp("diagnose")
    params = JaxMBT(num_filters=8).init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                        training=True, rng=jax.random.PRNGKey(1))["params"]
    run = d / "mbt2018-num_filters=8-lmbda=0.01"
    os.makedirs(run)
    np.savez(run / "params-0.npz", **{k: np.asarray(v) for k, v in
                                      traverse_util.flatten_dict(params, sep="/").items()})
    with open(run / "args.json", "w") as f:
        json.dump(dict(model="mbt2018", num_filters=8), f)
    np.save(d / "crops.npy", np.load(PHOTOS)[:2, 100:170, 200:290])
    return d


def test_diagnose_photos_matches_nic_tpus(run_dir, tmp_path, monkeypatch, capsys):
    run = str(run_dir / "mbt2018-num_filters=8-lmbda=0.01")
    _run_script(jax_diagnose_photos, monkeypatch,
                [run, run_dir / "crops.npy", "--out", tmp_path / "ref.json"])
    ref_out = capsys.readouterr().out
    got = diagnose_photos.main([run, str(run_dir / "crops.npy"), "--out",
                                str(tmp_path / "got.json"), "--device", "cpu"])
    got_out = capsys.readouterr().out
    with open(tmp_path / "ref.json") as f:
        ref = json.load(f)
    with open(tmp_path / "got.json") as f:
        assert json.load(f) == got
    _assert_records(got, ref, ROW_RTOL)
    assert len(got_out.splitlines()) == len(ref_out.splitlines())
    assert got_out.splitlines()[0] == ref_out.splitlines()[0]  # the params line


def test_diagnose_photos_full_width_matches_nic_tpus(tmp_path, monkeypatch):
    photo = tmp_path / "photo_0.npy"
    np.save(photo, np.load(PHOTOS)[:1])
    monkeypatch.chdir(ROOT)
    _run_script(jax_diagnose_photos, monkeypatch,
                [VAL_RUN, photo, "--out", tmp_path / "ref.json"])
    with open(tmp_path / "ref.json") as f:
        ref = json.load(f)
    got = diagnose_photos.main([VAL_RUN, str(photo), "--device", "cpu"])
    _assert_records(got, ref, FULL_WIDTH_RTOL)
    assert got["rows"][0]["sig_hi"] == 0.0


@pytest.mark.parametrize("seed,n,size", [(0, 64, 64), (99, 2, 64), (5, 3, 17)])
def test_synthetic_images_equal_nic_tpus(seed, n, size):
    got = demo.synthetic_images(np.random.default_rng(seed), n, size)
    ref = jax_demo.synthetic_images(np.random.default_rng(seed), n, size)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_demo_runs_end_to_end_on_the_cpu(capsys):
    out = demo.main(["--num_filters", "4", "--steps", "5", "--sga_its", "3",
                     "--device", "cpu"])
    text = capsys.readouterr().out
    assert out["steps"] == 5 and out["streams_exact"]
    for part in ("amortized", "sga"):
        assert out[part]["bytes"] > 0 and np.isfinite(out[part]["rd_objective"])
    for header in ("== training mbt2018 (nf=4, 5 steps) ==",
                   "== SGA iterative inference (3 its) ==",
                   "== real bitstream for the SGA latents (beyond the reference) =="):
        assert header in text


@pytest.mark.parametrize("tool,argv", [(diagnose_photos, ["run", "eval.npy"]), (demo, [])])
def test_tools_need_a_card_unless_asked_for_the_cpu(tool, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)
