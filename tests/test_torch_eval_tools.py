"""The port's evaluation and reporting tools against nic_tpu's, on the CPU:
``evaluation/golden.py`` and ``tools/{bd_report,rd_curve,validate_rd,
converge_aux}.py`` against ``nic_tpu/evaluation/golden.py`` and
``scripts/*.py`` (imported with ``scripts/`` on ``sys.path``, as nic_tpu's
own tests import them), on runs these tests make: nic_tpu's init at nf=8
under two lambdas, and photo crops.

Tolerances:
- golden: equal, bit for bit, on 200 seeded points per curve;
- bd_report's stdout and rd_curve's CSV and JSON files: equal, byte for byte;
- rd_curve's amortized rows (bf16 transforms on both sides): bpp within
  0.5 % and PSNR within 0.05 dB. K1's bf16 normalizer stays in float32 and
  nic_tpu's default XLA GDN rounds it to bf16; 0.5 % is the bound of
  ``test_torch_bf16.py`` against that route;
- rd_curve's SGA row, fed nic_tpu's Gumbel draws, against nic_tpu's engine
  with its Pallas GDN (K1's semantics): 1e-3 relative (``SGA_RTOL`` of
  ``test_torch_bf16.py``);
- validate_rd: the same decision, printed lines and VALIDATION.json fields
  on the same per-method results;
- converge_aux: the loss before within 1e-5 relative of nic_tpu's aux loss
  evaluated in float64 (the port computes in float32); after 300 steps within 1 % of nic_tpu's (Adam's steps on
  an L1 loss in float32, and each side keeps its own best iterate: the port
  the one whose loss it measured, nic_tpu the one after that update).
"""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import nic_tpu.coding.bb_codec
import nic_tpu.infer.bb
import nic_tpu.infer.engine
from nic_tpu.evaluation import golden as jax_golden
from nic_tpu.infer.engine import LatentOptimizer as JaxLatentOptimizer
from nic_tpu.infer.methods import SGA as JAX_SGA
from nic_tpu.models.mbt2018 import MeanScaleHyperprior as JaxMBT
from nic_tpu.models.mbt2018_bb import BitsBackHyperprior as JaxBB
from nic_tpu.train.checkpoint import load_params_npz as jax_load_params_npz
from nic_tpu_torch import config
from nic_tpu_torch.checkpoint import load_model
from nic_tpu_torch.evaluation import golden
from nic_tpu_torch.infer.engine import LatentOptimizer
from nic_tpu_torch.tools import bd_report, converge_aux, rd_curve, validate_rd

from test_torch_engine import jax_gumbel_fn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import bd_report as jax_bd_report  # noqa: E402
import converge_aux as jax_converge_aux  # noqa: E402
import rd_curve as jax_rd_curve  # noqa: E402
import validate_rd as jax_validate_rd  # noqa: E402

torch.set_num_threads(1)

PHOTOS = os.path.join(ROOT, "data_real", "eval_photos.npy")
LMBDAS = ("0.003", "0.01")
RUN = "mbt2018-num_filters=8-lmbda=0.01"
BB_RUN = "mbt2018_bb-num_filters=8-lmbda=0.01"
BPP_RTOL = 0.005
PSNR_ATOL_DB = 0.05
SGA_RTOL = 1e-3
AUX_BEFORE_RTOL = 1e-5
AUX_AFTER_RTOL = 0.01


def _flat(params):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}


def _jax_init(model):
    return _flat(model(num_filters=8).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), training=True,
        rng=jax.random.PRNGKey(1))["params"])


def _make_run(ckpt_dir, runname, flat, model="mbt2018", orbax_dir=False):
    """A run directory: params-0.npz and args.json, and with ``orbax_dir``
    an empty ckpt-0/ (nic_tpu's validate_rd asks for an orbax step; its
    restore then reads the npz of that step)."""
    run_dir = os.path.join(ckpt_dir, runname)
    os.makedirs(run_dir)
    np.savez(os.path.join(run_dir, "params-0.npz"), **flat)
    with open(os.path.join(run_dir, "args.json"), "w") as f:
        json.dump(dict(model=model, num_filters=8), f)
    if orbax_dir:
        os.makedirs(os.path.join(run_dir, "ckpt-0"))
    return run_dir


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """nic_tpu's nf=8 init under two lambdas, and a 2 x 64 x 64 .npy."""
    d = tmp_path_factory.mktemp("eval_tools")
    flat = _jax_init(JaxMBT)
    for lm in LMBDAS:
        _make_run(str(d / "ckpt"), f"mbt2018-num_filters=8-lmbda={lm}", flat)
    np.save(d / "crops.npy", np.load(PHOTOS)[:2, 100:164, 200:264])
    return d


def _run_script(module, monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", [module.__file__] + [str(a) for a in argv])
    return module.main()


# ------------------------------------------------------------------ golden


def test_golden_table_equals_nic_tpus():
    assert golden.GOLDEN_RD == jax_golden.GOLDEN_RD


CURVES = [(d, m) for d in sorted(jax_golden.GOLDEN_RD) for m in sorted(jax_golden.GOLDEN_RD[d])]


@pytest.mark.parametrize("dataset,method", CURVES)
def test_golden_functions_equal_nic_tpus_bit_for_bit(dataset, method):
    """200 seeded points around and beyond each curve's range: the
    interpolation, the check at a random tolerance and the gap of every
    run of 5 points."""
    rng = np.random.default_rng(CURVES.index((dataset, method)))
    bpps = rng.uniform(0.0, 1.5, 200)
    psnrs = rng.uniform(24.0, 41.0, 200)
    tols = rng.uniform(0.0, 0.5, 200)
    for b, p, t in zip(bpps, psnrs, tols):
        got = golden.interp_psnr_at_bpp(dataset, method, b)
        assert got == jax_golden.interp_psnr_at_bpp(dataset, method, b)
        assert (golden.check_rd_point(dataset, method, b, p, t)
                == jax_golden.check_rd_point(dataset, method, b, p, t))
        assert (golden.check_rd_point(dataset, method, b, got)
                == jax_golden.check_rd_point(dataset, method, b, got))
    points = list(zip(bpps, psnrs))
    for i in range(0, 200, 5):
        assert (golden.bd_psnr_gap(dataset, method, points[i:i + 5])
                == jax_golden.bd_psnr_gap(dataset, method, points[i:i + 5]))


# --------------------------------------------------------------- bd_report


@pytest.mark.parametrize("results,methods", [
    ("photos_synth3", None),
    ("synth3_bb", "bb_plain:mbt2018,bb_sga:bb_sga"),
    ("no_such_dir", None),
])
def test_bd_report_prints_nic_tpus_report(results, methods, monkeypatch, capsys):
    argv = [os.path.join(ROOT, "results", results)] + (["--methods", methods] if methods else [])
    _run_script(jax_bd_report, monkeypatch, argv)
    ref = capsys.readouterr().out
    report = bd_report.main(argv)
    assert capsys.readouterr().out == ref
    if results != "no_such_dir":
        assert len(report) == 2
        assert all(len(r["deltas"]) == len(r["points"]) >= 4 for r in report.values())


# ------------------------------------------------------------ rd_curve: parts


def test_find_runs_matches_nic_tpu_and_finds_port_runs(tmp_path):
    """The tree of ``test_rd_curve_tools.py``, plus a run with only the
    port's full state (both find it) and one with only an orbax tree, which
    the port cannot read and skips."""
    for name in ("mbt2018-num_filters=192-lmbda=0.01", "mbt2018-num_filters=192-lmbda=0.003",
                 "mbt2018_bb-num_filters=192-lmbda=0.01", "mbt2018-num_filters=128-lmbda=0.01"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "params-100.npz").write_bytes(b"x")
    (tmp_path / "mbt2018-num_filters=192-lmbda=0.08").mkdir()
    (tmp_path / "mbt2018-num_filters=192-lmbda=0.04").mkdir()
    (tmp_path / "mbt2018-num_filters=192-lmbda=0.04" / "ckpt-7.pt").write_bytes(b"x")
    (tmp_path / "mbt2018-num_filters=192-lmbda=0.02" / "ckpt-7").mkdir(parents=True)
    for model in ("mbt2018", "mbt2018_bb"):
        for nf in (192, 128):
            ours = rd_curve.find_runs(str(tmp_path), nf, model)
            ref = jax_rd_curve.find_runs(str(tmp_path), nf, model)
            assert ours == [r for r in ref if r[1] != 0.02]
    assert [r[1] for r in rd_curve.find_runs(str(tmp_path), 192)] == [0.003, 0.01, 0.04]


def test_merge_refuses_a_foreign_eval_set_as_nic_tpu(tmp_path):
    row_a = {"runname": "r1", "lmbda": 0.01, "eval": "a.npy",
             "methods": {"sga": {"bpp": 0.4, "psnr": 33.0}}}
    (tmp_path / "rd_curve.json").write_text(json.dumps([row_a]))
    messages = []
    for merge in (rd_curve._merge_detail, jax_rd_curve._merge_detail):
        with pytest.raises(SystemExit, match="refusing to merge") as info:
            merge(str(tmp_path), [dict(row_a, eval="b.npy")])
        messages.append(str(info.value))
        assert merge(str(tmp_path), [dict(row_a, lmbda=0.02)]) == [dict(row_a, lmbda=0.02)]
    assert messages[0] == messages[1]


def _row(runname, lmbda, rng, methods=("amortized", "sga")):
    return dict(runname=runname, lmbda=lmbda, step=100, eval="e.npy",
                methods={m: dict(bpp=float(rng.uniform(0.1, 1.2)),
                                 psnr=float(rng.uniform(25, 35)),
                                 msssim=float("nan") if m == "sga" else float(rng.random()),
                                 secs=float(rng.random())) for m in methods})


@pytest.mark.parametrize("fresh", [False, True])
def test_write_artifacts_writes_nic_tpus_bytes(tmp_path, fresh):
    """The same rows, over the same rd_curve.json already on disk (merged,
    or replaced with ``fresh``): every file equal byte for byte."""
    rng = np.random.default_rng(5)
    on_disk = [_row("run-a", 0.01, rng), _row("run-c", 0.003, rng, ("amortized",))]
    detail = [_row("run-a", 0.01, rng), _row("run-b", 0.04, rng, ("sga", "map"))]
    out = {}
    for side, write in (("port", rd_curve._write_artifacts),
                        ("jax", jax_rd_curve._write_artifacts)):
        d = tmp_path / side
        d.mkdir()
        (d / "rd_curve.json").write_text(json.dumps(on_disk, indent=2))
        curve = write(str(d), detail, verbose=True, fresh=fresh)
        out[side] = (curve, {f: (d / f).read_bytes() for f in sorted(os.listdir(d))})
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1]
    assert "map-psnr.csv" in out["port"][1]
    assert ("run-c" in out["port"][1]["rd_curve.json"].decode()) == (not fresh)


def test_evaluate_chunks_by_the_pixel_budget(monkeypatch):
    """A budget of two images' pixels: batches of 2 and 1, means over all."""
    monkeypatch.setattr(config, "EVAL_BATCH_NUM_PIXELS", 2 * 8 * 8)
    calls = []

    def fn(x):
        calls.append(len(x))
        n = np.arange(len(x), dtype=np.float32) + len(calls)
        return dict(est_bpp=n, psnr=10 * n, msssim=n / 10)

    res = rd_curve.evaluate(fn, np.zeros((3, 8, 8, 3), np.float32))
    assert calls == [2, 1]
    n = np.float32([1, 2, 2])
    assert res == dict(bpp=float(np.mean(n)), psnr=float(np.mean(10 * n)),
                       msssim=float(np.mean(n / 10)))


# -------------------------------------------------------- rd_curve: end to end


def test_rd_curve_amortized_rows_match_nic_tpu(runs, monkeypatch):
    """Both tools on the two nf=8 runs: the same rows, bpp within 0.5 % and
    PSNR within 0.05 dB, and CSVs of the reference's format."""
    common = [runs / "crops.npy", "--checkpoint_dir", runs / "ckpt", "--methods",
              "amortized", "--num_filters", "8"]
    _run_script(jax_rd_curve, monkeypatch, common + ["--out", runs / "rd_jax"])
    detail = rd_curve.main([str(a) for a in common] + ["--out", str(runs / "rd_port"),
                                                       "--device", "cpu"])
    ref = json.loads((runs / "rd_jax" / "rd_curve.json").read_text())
    got = json.loads((runs / "rd_port" / "rd_curve.json").read_text())
    assert json.dumps(detail, indent=2) == (runs / "rd_port" / "rd_curve.json").read_text()
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert {k: g[k] for k in ("runname", "lmbda", "step", "eval")} == \
            {k: r[k] for k in ("runname", "lmbda", "step", "eval")}
        g, r = g["methods"]["amortized"], r["methods"]["amortized"]
        assert abs(g["bpp"] - r["bpp"]) <= BPP_RTOL * r["bpp"]
        assert abs(g["psnr"] - r["psnr"]) <= PSNR_ATOL_DB
    assert sorted(os.listdir(runs / "rd_port")) == sorted(os.listdir(runs / "rd_jax"))
    lines = (runs / "rd_port" / "amortized-psnr.csv").read_text().splitlines()
    assert len(lines) == 2 and all(re.fullmatch(r"\d+\.\d{4},\d+\.\d{6}", x) for x in lines)


def test_rd_curve_sga_row_matches_nic_tpus_engine(runs):
    """The tool's evaluation of an SGA batch (bf16, 8 steps) fed nic_tpu's
    Gumbel draws, against nic_tpu's engine on the same parameters."""
    steps = 8
    x = np.load(runs / "crops.npy").astype(np.float32) / 255.0
    _, jparams = jax_load_params_npz(str(runs / "ckpt" / RUN / "params-0.npz"))
    jmodel = JaxMBT(num_filters=8, compute_dtype=jnp.bfloat16, use_pallas_gdn=True)
    ref = JaxLatentOptimizer(jmodel, jparams).optimize(
        x, 0.01, method=JAX_SGA.replace(iterations=steps), seed=0)
    _, model = load_model(str(runs / "ckpt"), RUN, 8, "cpu", compute_dtype=torch.bfloat16)
    fn = rd_curve.method_fn(LatentOptimizer(model, "cpu"), "mbt2018", "sga", 0.01, steps,
                            noise_fn=jax_gumbel_fn(0, steps))
    got = rd_curve.evaluate(fn, x)
    assert abs(got["bpp"] - np.mean(ref["est_bpp"])) <= SGA_RTOL * np.mean(ref["est_bpp"])
    assert abs(got["psnr"] - np.mean(ref["psnr"])) <= SGA_RTOL * np.mean(ref["psnr"])


# ------------------------------------------------------------- validate_rd


class FakeOptimizer:
    """Stands in for either package's optimizer: every method returns the
    results set on the class, by name."""

    results = {}

    def __init__(self, *args, **kwargs):
        pass

    def eval_amortized(self, x):
        return self.results["amortized"]

    def optimize(self, x, lmbda, method=None, seed=0, spec=None):
        return self.results[(method or spec).name]


class FakeCodec:
    def __init__(self, *args, **kwargs):
        pass

    def compress(self, x, seed=0):
        return b"p", dict(net_bpp=0.5)

    def decompress(self, blob):
        return None, True

    def compress_optimized(self, x, y, z_mean, z_logvar, seed=0):
        return b"o", dict(net_bpp=0.45, delta_bpp=0.01)

    def decompress_optimized(self, blob):
        return None, blob == b"o"


def _results(rng, rd, **extra):
    """Per-image results whose lambda=0.01 objective is about ``rd``."""
    out = {}
    for name, target in rd.items():
        bpp = rng.uniform(0.3, 0.5, 2)
        mse = (target - bpp) / 0.01 + rng.normal(0, 0.01, 2)
        out[name] = dict(est_bpp=bpp, psnr=rng.uniform(25, 30, 2), mse=mse,
                         msssim=rng.random(2), **{k: rng.random(2) for k in extra})
    return out


def _tail(text):
    """The printed lines from the eval batch on, the last without its path."""
    return [x.split(" -> ")[0] for x in text.split("eval batch", 1)[1].splitlines()]


def _validation(run_dir):
    with open(os.path.join(run_dir, "VALIDATION.json")) as f:
        record = json.load(f)
    for r in record["results"].values():
        r.pop("secs")
    return record


@pytest.fixture(scope="module")
def bb_flat():
    return _jax_init(JaxBB)


@pytest.mark.parametrize("case,rd,code", [
    ("pass", dict(amortized=1.0, sga=0.8, map=0.9, ste=0.95, unoise=0.85, danneal=0.82), 0),
    ("warn", dict(amortized=1.0, sga=0.8, map=1.2, ste=0.95, unoise=1.01, danneal=0.7), 0),
    ("fail", dict(amortized=1.0, sga=1.05, map=0.9, ste=0.95, unoise=0.85, danneal=0.82), 1),
])
def test_validate_rd_decides_as_nic_tpu(tmp_path, monkeypatch, capsys, case, rd, code):
    FakeOptimizer.results = _results(np.random.default_rng(len(case)), rd)
    monkeypatch.setattr(nic_tpu.infer.engine, "LatentOptimizer", FakeOptimizer)
    monkeypatch.setattr(validate_rd, "LatentOptimizer", FakeOptimizer)
    flat = _jax_init(JaxMBT)
    argv = [RUN, PHOTOS, "--num_filters", "8", "--its", "3", "--checkpoint_dir"]
    outs, records = [], []
    for side, run in (("jax", lambda a: _run_script(jax_validate_rd, monkeypatch, a)),
                      ("port", lambda a: validate_rd.main(a + ["--device", "cpu"]))):
        ckpt = tmp_path / side
        run_dir = _make_run(str(ckpt), RUN, flat, orbax_dir=side == "jax")
        assert run(argv + [str(ckpt)]) == code
        outs.append(_tail(capsys.readouterr().out))
        records.append(_validation(run_dir))
    assert outs[0] == outs[1]
    assert records[0] == records[1]
    assert outs[1][-1] == ("PASS" if code == 0 else "FAIL")
    assert any(x.startswith("WARN") for x in outs[1]) == (case == "warn")


@pytest.mark.parametrize("plain_rd,code", [(1.0, 0), (0.7, 1)])
def test_validate_rd_bb_decides_as_nic_tpu(tmp_path, monkeypatch, capsys, bb_flat,
                                           plain_rd, code):
    FakeOptimizer.results = _results(np.random.default_rng(2), dict(
        bb_plain=plain_rd, bb_no_sga=0.9, bb_sga=0.8), est_bpp_back=1, y=1, z_mean=1,
        z_logvar=1)
    FakeOptimizer.results["bb_no_sga"]["est_bpp"] = FakeOptimizer.results["bb_plain"][
        "est_bpp"] - 0.01
    monkeypatch.setattr(nic_tpu.infer.bb, "BBLatentOptimizer", FakeOptimizer)
    monkeypatch.setattr(nic_tpu.coding.bb_codec, "BitsBackCodec", FakeCodec)
    monkeypatch.setattr(validate_rd, "BBLatentOptimizer", FakeOptimizer)
    monkeypatch.setattr(validate_rd, "BitsBackCodec", FakeCodec)
    argv = [BB_RUN, PHOTOS, "--num_filters", "8", "--bb", "--checkpoint_dir"]
    outs, records = [], []
    for side, run in (("jax", lambda a: _run_script(jax_validate_rd, monkeypatch, a)),
                      ("port", lambda a: validate_rd.main(a + ["--device", "cpu"]))):
        ckpt = tmp_path / side
        run_dir = _make_run(str(ckpt), BB_RUN, bb_flat, "mbt2018_bb", orbax_dir=side == "jax")
        assert run(argv + [str(ckpt)]) == code
        outs.append(_tail(capsys.readouterr().out))
        records.append(_validation(run_dir))
    assert outs[0] == outs[1] and records[0] == records[1]


def test_validate_rd_bb_streams_decode_on_the_cpu(tmp_path, monkeypatch, capsys, bb_flat):
    """The real path at nf=8 on one 64x64 crop, each method cut to a few
    steps: both BB-ANS streams give their initial bits back, and
    VALIDATION.json has nic_tpu's fields."""
    short = {"bb_plain": validate_rd.BB_PLAIN,
             "bb_no_sga": validate_rd.BB_NO_SGA.replace(rate_iterations=6),
             "bb_sga": validate_rd.BB_SGA.replace(rd_iterations=6, rate_iterations=6)}
    monkeypatch.setattr(validate_rd, "BB_SPECS", short)
    np.save(tmp_path / "crop.npy", np.load(PHOTOS)[:1, 100:164, 200:264])
    run_dir = _make_run(str(tmp_path / "ckpt"), BB_RUN, bb_flat, "mbt2018_bb")
    code = validate_rd.main([BB_RUN, str(tmp_path / "crop.npy"), "--num_filters", "8", "--bb",
                             "--checkpoint_dir", str(tmp_path / "ckpt"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("bits recovered: True") == 2
    verdict = "PASS" if code == 0 else "FAIL"
    assert out.rstrip().endswith(f"{verdict} -> {run_dir}/VALIDATION.json")
    record = json.load(open(os.path.join(run_dir, "VALIDATION.json")))
    assert set(record) == {"step", "lmbda", "results", "actual"}
    assert set(record["results"]) == {"bb_plain", "bb_no_sga", "bb_sga"}
    assert all(set(r) == {"net_bpp", "psnr", "rd_loss", "bpp_back", "secs"}
               for r in record["results"].values())
    assert set(record["actual"]) == {"bb_plain_net_bpp", "bb_sga_net_bpp", "bb_sga_delta_bpp"}
    assert all(np.isfinite(v) for v in record["actual"].values())


# ------------------------------------------------------------ converge_aux


def test_converge_aux_dry_run_reads_nic_tpus_loss(monkeypatch, capsys):
    """On the committed lambda=0.01 run, which the dry run leaves as it is:
    the loss nic_tpu's script prints, and nic_tpu's aux loss of the same
    parameters evaluated in float64. Its float32 evaluation rounds a sum of
    576 terms near +-21 and is itself ~1e-5 off (8.6e-6 measured; the port's
    float32 1.5e-6), and moves by that much between XLA compilations."""
    run_dir = os.path.join(ROOT, "checkpoints_synth3", "mbt2018-num_filters=192-lmbda=0.01")
    _run_script(jax_converge_aux, monkeypatch, [run_dir, "--dry_run", "--threshold", "0"])
    printed = float(re.search(r"aux_loss before = ([0-9.]+)", capsys.readouterr().out).group(1))
    res = converge_aux.main([run_dir, "--dry_run", "--threshold", "0", "--device", "cpu"])
    assert "dry run" in capsys.readouterr().out and not res["rewritten"]
    assert f"{res['before']:.3f}" == f"{printed:.3f}"
    flat = {k: v.astype(np.float64) for k, v in _flat(jax_load_params_npz(res["npz"])[1]).items()}
    with jax.enable_x64(True):
        exact = float(JaxMBT(num_filters=192).apply(
            {"params": traverse_util.unflatten_dict(flat, sep="/")}, method=JaxMBT.aux_loss))
    assert abs(res["before"] - exact) <= AUX_BEFORE_RTOL * exact


def test_converge_aux_converges_as_nic_tpu(tmp_path, monkeypatch, capsys):
    """300 steps to threshold 0 on copies of nic_tpu's nf=8 init: only the
    quantiles change, the loss falls to within 1 % of nic_tpu's, and both
    packages load the rewritten archive."""
    flat = _jax_init(JaxMBT)
    dirs = {side: _make_run(str(tmp_path / side), RUN, flat) for side in ("jax", "port")}
    _run_script(jax_converge_aux, monkeypatch, [dirs["jax"], "--steps", "300",
                                                "--threshold", "0"])
    ref_after = float(re.search(r"aux_loss after \d+ steps = ([0-9.]+)",
                                capsys.readouterr().out).group(1))
    res = converge_aux.main([dirs["port"], "--steps", "300", "--threshold", "0",
                             "--device", "cpu"])
    assert res["rewritten"] and res["steps"] == 300
    assert res["after"] < res["before"]
    assert abs(res["after"] - ref_after) <= AUX_AFTER_RTOL * ref_after
    for side, run_dir in dirs.items():
        with np.load(os.path.join(run_dir, "params-0.npz")) as z:
            new = {k: z[k] for k in z.files}
        assert set(new) == set(flat)
        for k, v in flat.items():
            assert new[k].dtype == np.float32, k
            if "quantiles" in k:
                assert not np.array_equal(new[k], v), (side, k)
            else:
                assert new[k].tobytes() == v.astype(np.float32).tobytes(), (side, k)
    jax_load_params_npz(os.path.join(dirs["port"], "params-0.npz"))
    _, model = load_model(str(tmp_path / "port"), RUN, 8, "cpu")
    with torch.no_grad():
        assert abs(float(model.aux_loss()) - res["after"]) <= 1e-6 * res["after"]


def test_converge_aux_refuses_the_bits_back_model(tmp_path, monkeypatch, bb_flat):
    run_dir = _make_run(str(tmp_path), BB_RUN, bb_flat, "mbt2018_bb")
    messages = []
    for run in (lambda: _run_script(jax_converge_aux, monkeypatch, [run_dir]),
                lambda: converge_aux.main([run_dir, "--device", "cpu"])):
        with pytest.raises(SystemExit) as info:
            run()
        messages.append(str(info.value.code))
    assert messages[0] == messages[1] and "no aux (quantile) loss" in messages[0]


# ------------------------------------------------------ devices and imports


@pytest.mark.parametrize("tool,argv", [
    (rd_curve, ["x.npy"]),
    (validate_rd, [RUN, "x.npy"]),
    (converge_aux, ["run_dir"]),
])
def test_tools_run_on_the_card_unless_asked(tool, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)


_IMPORT_CHECK = r"""
import importlib, json, sys
names = ["nic_tpu_torch.evaluation.golden", "nic_tpu_torch.tools.bd_report",
         "nic_tpu_torch.tools.rd_curve", "nic_tpu_torch.tools.validate_rd",
         "nic_tpu_torch.tools.converge_aux", "nic_tpu_torch.train.summaries",
         "nic_tpu_torch.train.prior_trainer"]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "nic_tpu"))
print(json.dumps(bad))
"""


def test_new_modules_import_neither_jax_nor_nic_tpu():
    """``nic_tpu_torch`` starts with ``nic_tpu``: the check is on the first
    dotted part."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
