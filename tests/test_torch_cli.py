"""The port's command line, on the CPU: ``sga``, ``map``, ``ste`` and
``danneal compress --device cpu`` against nic_tpu's CLI on the same
checkpoint and images, the methods' streams, ``--data_parallel`` and
``--spatial`` over gloo ranks and their refusals, ``train`` (a run served by
``compress`` -> ``decompress``, a resume, the bits-back model, ``--retries``,
the multi-host flags' checks) and ``learned_prior``, the refusals nic_tpu makes
too, the device policy, and the port's independence from JAX.

Tolerance: float32 values 1e-5 relative, elementwise with an absolute floor
of the same fraction of the largest reference magnitude.
"""

import ast
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from PIL import Image

from nic_tpu.cli.main import main as jax_main
from nic_tpu.models.mbt2018 import MeanScaleHyperprior as JaxMBT
from nic_tpu_torch.cli.main import main
from nic_tpu_torch.evaluation.results import rd_results_filename

torch.set_num_threads(1)

VALUE_RTOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = "mbt2018-num_filters=8-lmbda=0.01"
FIELDS = ("mse", "psnr", "msssim", "msssim_db", "est_bpp", "est_y_bpp", "est_z_bpp")


def assert_rel(actual, expected, rtol=VALUE_RTOL):
    actual = np.asarray(actual, np.float64)
    expected = np.asarray(expected, np.float64)
    floor = rtol * max(float(np.nanmax(np.abs(expected), initial=0.0)), 1e-30)
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=floor)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A JAX-initialized nf=8 checkpoint and two 64x64 photo crops."""
    d = tmp_path_factory.mktemp("cli")
    params = JaxMBT(num_filters=8).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), training=True,
        rng=jax.random.PRNGKey(1))["params"]
    run_dir = d / "ckpt" / RUN
    run_dir.mkdir(parents=True)
    flat = traverse_util.flatten_dict(params, sep="/")
    np.savez(run_dir / "params-0.npz", **{k: np.asarray(v) for k, v in flat.items()})
    photos = np.load(os.path.join(ROOT, "data_real", "eval_photos.npy"))
    np.save(d / "crops.npy", photos[:2, 100:164, 200:264])
    return d


def _argv(workdir, results, *extra, script="sga", its="0"):
    return ["--num_filters", "8", "--checkpoint_dir", str(workdir / "ckpt"), script,
            "compress", RUN, str(workdir / "crops.npy"), "--results_dir", str(results),
            "--sga_its", its, *extra]


def test_sga_compress_matches_jax_cli(workdir, capsys):
    """With no SGA steps both CLIs transmit the plainly rounded amortized
    latents, so their rd-*.npz files agree field by field."""
    jax_main(_argv(workdir, workdir / "res_jax"))
    out = main(["--device", "cpu"] + _argv(workdir, workdir / "res_port"))
    name = rd_results_filename("sga", RUN, "crops.npy", 0.01)
    ref = np.load(workdir / "res_jax" / name)
    got = np.load(workdir / "res_port" / name)
    assert set(got.files) == set(ref.files) == set(FIELDS)
    for k in FIELDS:
        assert got[k].shape == ref[k].shape == (2,)
        assert_rel(got[k], ref[k])
    assert set(out["results"]) == set(FIELDS) and out["steps"] == [0]
    printed = capsys.readouterr().out
    for k in FIELDS:
        assert f"Avg {k}:" in printed


def test_sga_compress_writes_results_and_opt_record(workdir):
    results = workdir / "res_steps"
    out = main(["--device", "cpu"] + _argv(workdir, results, "--save_opt_record",
                                           "--seed", "3", its="4"))
    rd = np.load(results / rd_results_filename("sga", RUN, "crops.npy", 0.01))
    opt = np.load(results / rd_results_filename("sga", RUN, "crops.npy", 0.01,
                                                prefix="opt"))
    assert np.all(np.isfinite(rd["est_bpp"])) and rd["est_bpp"].shape == (2,)
    assert opt["rd_loss"].shape == (4,) and np.all(np.isfinite(opt["rd_loss"]))
    np.testing.assert_array_equal(opt["its"], np.arange(4))
    assert out["steps"] == [4] and len(out["loop_ms"]) == 1


@pytest.mark.parametrize("script,its", [("map", "2000"), ("ste", "2000"),
                                        ("danneal", "6")])
def test_method_compress_matches_jax_cli(workdir, capsys, script, its):
    """The deterministic methods through both CLIs on the nf=8 checkpoint
    and the two crops: map and ste at their full iteration count stop early
    (map after 41 steps, ste after 161), danneal runs a few steps."""
    jax_main(_argv(workdir, workdir / f"res_jax_{script}", script=script, its=its))
    out = main(["--device", "cpu"] + _argv(workdir, workdir / f"res_port_{script}",
                                           script=script, its=its))
    name = rd_results_filename(script, RUN, "crops.npy", 0.01)
    ref = np.load(workdir / f"res_jax_{script}" / name)
    got = np.load(workdir / f"res_port_{script}" / name)
    for k in FIELDS:
        assert got[k].shape == ref[k].shape == (2,)
        assert_rel(got[k], ref[k])
    steps = {"map": 41, "ste": 161, "danneal": 6}[script]
    assert out["steps"] == [steps]
    assert f"{script}: {steps} steps on 2 image(s)" in capsys.readouterr().out


@pytest.mark.parametrize("script,extra", [("unoise", ()), ("danneal", ())])
def test_method_streams_decode_exactly(workdir, script, extra):
    """unoise (quantized_z mean, through compress_latents) and danneal
    (integer latents, through compress_optimized) write streams that
    decompress to the compress side's pixels."""
    stream = workdir / f"{script}.ntc"
    png = workdir / f"{script}.png"
    out = main(["--device", "cpu"] + _argv(workdir, workdir / f"res_{script}_stream",
                                           str(stream), *extra, script=script, its="3"))
    assert stream.exists() and out["bytes"] == stream.stat().st_size
    dec = main(["--device", "cpu", "--num_filters", "8", "--checkpoint_dir",
                str(workdir / "ckpt"), script, "decompress", RUN, str(stream), str(png)])
    got = np.round(dec["x_hat"] * 255.0).astype(np.uint8)
    np.testing.assert_array_equal(got, out["pixels"])
    assert png.exists()


@pytest.mark.parametrize("script,extra", [
    ("map", ()), ("unoise", ("--unoise_mean_source", "noisy_z")),
])
def test_undecodable_methods_write_no_stream(workdir, capsys, script, extra):
    stream = workdir / f"{script}_undecodable.ntc"
    out = main(["--device", "cpu"] + _argv(workdir, workdir / f"res_{script}_nostream",
                                           str(stream), *extra, script=script, its="2"))
    assert not stream.exists() and "bytes" not in out
    assert f"WARNING: not writing {stream}" in capsys.readouterr().err


def test_opt_record_skips_empty_histories_and_holds_verbose_probes(workdir):
    """map keeps no loss history, so --save_opt_record writes no record; a
    fixed-length method's record holds its --verbose probes every 100 steps."""
    results = workdir / "res_records"
    main(["--device", "cpu"] + _argv(workdir, results, "--save_opt_record",
                                     script="map", its="5"))
    assert not (results / rd_results_filename("map", RUN, "crops.npy", 0.01,
                                              prefix="opt")).exists()
    main(["--device", "cpu", "--verbose"] + _argv(workdir, results, "--save_opt_record",
                                                  script="danneal", its="102"))
    rec = np.load(results / rd_results_filename("danneal", RUN, "crops.npy", 0.01,
                                                prefix="opt"))
    probed = np.isfinite(rec["rd_loss_after_rounding"])
    np.testing.assert_array_equal(np.flatnonzero(probed), [0, 100])
    assert rec["rd_loss"].shape == (102,) and np.all(np.isfinite(rec["rd_loss"]))


@pytest.mark.parametrize("script", ["map", "ste", "unoise", "danneal"])
def test_methods_raise_without_a_card(workdir, monkeypatch, script):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(_argv(workdir, workdir / "res_nocard", script=script))


def test_default_device_raises_without_a_card(workdir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(_argv(workdir, workdir / "res_nocard"))
    from nic_tpu_torch.infer.engine import LatentOptimizer
    from nic_tpu_torch.models.mbt2018 import MeanScaleHyperprior

    with pytest.raises(RuntimeError, match="no CUDA device"):
        LatentOptimizer(MeanScaleHyperprior(8))


@pytest.mark.parametrize("extra,script,before", [
    (("--quant", "int4"), "mbt2018", ()),
    (("out.ntc", "--frobnicate"), "sga", ()),
    (("--quant", "int8"), "bb_plain", ()),
    (("--quant", "int8_all"), "bb_sga", ()),
    (("--quant", "int8"), "bb_no_sga", ("--verbose",)),
])
def test_unported_parts_exit_nonzero(workdir, extra, script, before):
    """Every flag of nic_tpu's command line is ported; what either CLI
    refuses, the port refuses as nic_tpu does: a value or a flag nic_tpu's
    parser does not know (argparse's exit 2, on both), and --quant on a
    bits-back script (nic_tpu's message, before any checkpoint is read)."""
    argv = ["--device", "cpu", *before] + _argv(workdir, workdir / "res_x", *extra,
                                                script=script)
    with pytest.raises(SystemExit) as info:
        main(argv)
    if script.startswith("bb_"):
        assert info.value.code == "--quant supports the mbt2018 model only"
        return
    with pytest.raises(SystemExit) as jax_info:
        jax_main(argv[2:])
    assert info.value.code == jax_info.value.code == 2


@pytest.mark.parametrize("extra,script,message", [
    (("--data_parallel", "--spatial"), "sga", "mutually exclusive"),
    (("--data_parallel", "--spatial"), "map", "mutually exclusive"),
    (("--spatial", "--distortion", "msssim"), "sga", "mse objective only"),
    (("--spatial", "--distortion", "msssim"), "unoise", "mse objective only"),
    (("--spatial",), "bb_plain", "only supported for"),
    (("--spatial",), "mbt2018", "only supported for"),
])
def test_parallel_flags_are_refused_as_nic_tpu(workdir, extra, script, message):
    """--data_parallel with --spatial, --spatial with MS-SSIM or on a script
    that runs no iterative loop: nic_tpu's messages."""
    codes = []
    for cli, before in ((main, ["--device", "cpu"]), (jax_main, [])):
        with pytest.raises(SystemExit) as info:
            cli(before + _argv(workdir, workdir / "res_refused", *extra, script=script))
        codes.append(str(info.value.code))
    assert message in codes[0] and codes[0] == codes[1]


def test_data_parallel_has_no_effect_on_mbt2018(workdir):
    ref = main(["--device", "cpu"] + _argv(workdir, workdir / "res_amortized",
                                           script="mbt2018"))
    out = main(["--device", "cpu"] + _argv(workdir, workdir / "res_amortized_dp",
                                           "--data_parallel", script="mbt2018"))
    for k in FIELDS:
        np.testing.assert_array_equal(out["results"][k], ref["results"][k])


def test_data_parallel_compress_matches_one_rank(workdir, capsys, monkeypatch):
    """sga --data_parallel over 2 gloo ranks: the 2 crops' results are the
    single rank's, and rank 0 alone prints and saves."""
    ref = main(["--device", "cpu"] + _argv(workdir, workdir / "res_one_rank", its="3"))
    monkeypatch.setenv("NIC_TPU_TORCH_CPU_RANKS", "2")
    out = main(["--device", "cpu"] + _argv(workdir, workdir / "res_dp", "--data_parallel",
                                           its="3"))
    assert "Data-parallel inference over 2 device(s)." in capsys.readouterr().out
    for k in FIELDS:
        assert_rel(out["results"][k], ref["results"][k])
    assert os.listdir(workdir / "res_dp") == [rd_results_filename("sga", RUN, "crops.npy", 0.01)]


@pytest.mark.parametrize("script", ["sga", "danneal"])
def test_spatial_stream_decodes_exactly(workdir, monkeypatch, script):
    """--spatial over 2 gloo ranks writes the last image's stream, which
    the unsharded decoder reads back to the compress side's pixels."""
    monkeypatch.setenv("NIC_TPU_TORCH_CPU_RANKS", "2")
    stream, png = workdir / f"{script}_spatial.ntc", workdir / f"{script}_spatial.png"
    out = main(["--device", "cpu"] + _argv(workdir, workdir / f"res_{script}_spatial",
                                           str(stream), "--spatial", script=script, its="3"))
    assert out["bytes"] == stream.stat().st_size and out["steps"] == [3]
    dec = main(["--device", "cpu", "--num_filters", "8", "--checkpoint_dir",
                str(workdir / "ckpt"), script, "decompress", RUN, str(stream), str(png)])
    np.testing.assert_array_equal(np.round(dec["x_hat"] * 255.0).astype(np.uint8),
                                  out["pixels"])


@pytest.mark.parametrize("extra,message", [
    (("--coordinator_address", "localhost:1"), "needs --num_processes and --process_id"),
    (("--coordinator_address", "localhost:1", "--num_processes", "3", "--process_id", "0"),
     "--batchsize 2 must divide by 3 processes."),
])
def test_multi_host_flags_are_checked(train_corpus, tmp_path, extra, message):
    with pytest.raises(SystemExit) as info:
        main(_train_argv(tmp_path / "ckpt", train_corpus, "mbt2018", 2, *extra))
    assert message in str(info.value.code)


@pytest.mark.parametrize("script", ["sga", "bb_plain"])
def test_method_scripts_refuse_train_as_nic_tpu(script):
    for cli in (main, jax_main):
        with pytest.raises(SystemExit) as info:
            cli([script, "train", "--train_glob", "x/*.png"])
        assert str(info.value.code) == f"{script} does not support training."


@pytest.fixture(scope="module")
def train_corpus(tmp_path_factory):
    """Three 96x128 photo crops as PNGs."""
    d = tmp_path_factory.mktemp("train_corpus")
    photos = np.load(os.path.join(ROOT, "data_real", "eval_photos.npy"))
    for i in range(3):
        Image.fromarray(photos[i, 100:196, 200:328]).save(d / f"img{i}.png")
    return d


def _train_argv(ckpt, corpus, script="mbt2018", last_step=4, *extra):
    return ["--device", "cpu", "--num_filters", "8", "--checkpoint_dir", str(ckpt), script,
            "train", "--train_glob", str(corpus / "img*.png"), "--patchsize", "64",
            "--batchsize", "2", "--last_step", str(last_step), "--steps_per_call", "2",
            *extra]


def test_train_then_serve_the_run_exactly(workdir, train_corpus, tmp_path):
    """mbt2018 train at nf=8 writes nic_tpu's run files and resumes; its
    newest parameters then compress and decompress the crops exactly."""
    ckpt = tmp_path / "ckpt"
    trainer = main(_train_argv(ckpt, train_corpus))
    run = ckpt / RUN
    assert trainer.step == 4 and len(trainer.losses) == 4
    assert {"args.json", "record.txt", "metrics.jsonl", "params-4.npz", "ckpt-4.pt",
            "mbt2018.py"} == set(os.listdir(run))
    args = json.load(open(run / "args.json"))
    assert args["num_filters"] == 8 and args["steps_per_call"] == 2
    assert main(_train_argv(ckpt, train_corpus, "mbt2018", 6)).last_timing["steps"] == 2
    assert sorted(os.listdir(run))[:3] == ["args.json", "ckpt-6.pt", "mbt2018.py"]
    stream, png = tmp_path / "t.ntc", tmp_path / "t.png"
    common = ["--device", "cpu", "--num_filters", "8", "--checkpoint_dir", str(ckpt), "mbt2018"]
    out = main(common + ["compress", RUN, str(workdir / "crops.npy"), str(stream),
                         "--results_dir", str(tmp_path / "res")])
    dec = main(common + ["decompress", RUN, str(stream), str(png)])
    np.testing.assert_array_equal(np.round(dec["x_hat"] * 255.0).astype(np.uint8),
                                  out["pixels"])


def test_train_bits_back_from_mbt2018(train_corpus, tmp_path):
    donor = tmp_path / "donor"
    main(_train_argv(donor, train_corpus, "mbt2018", 2))
    trainer = main(_train_argv(tmp_path / "bb", train_corpus, "mbt2018_bb", 2, "--init_from",
                               str(donor / RUN), "--init_from_partial"))
    assert trainer.step == 2 and np.all(np.isfinite(trainer.losses))
    assert os.path.exists(tmp_path / "bb" / "mbt2018_bb-num_filters=8-lmbda=0.01" / "params-2.npz")


def test_learned_prior_writes_its_weights(tmp_path):
    np.save(tmp_path / "y.npy", np.random.default_rng(0).normal(0, 2, (64, 4)).astype(np.float32))
    save_dir = main(["learned_prior", "--device", "cpu", "--num_channels", "4", "--data_path",
                     str(tmp_path / "y.npy"), "--its", "3", "--checkpoint_dir", str(tmp_path)])
    assert sorted(os.listdir(save_dir)) == ["args.json", "prior_model.npz", "record.json"]


def test_retries_rerun_training_after_a_crash(train_corpus, tmp_path, monkeypatch):
    """The first attempt finds no corpus and crashes; the supervisor's pause
    before the second brings the corpus, which then trains to the end."""
    from nic_tpu_torch.train import supervisor

    corpus = tmp_path / "late_corpus"

    def pause(_secs):
        shutil.copytree(train_corpus, corpus)

    monkeypatch.setattr(supervisor.time, "sleep", pause)
    monkeypatch.chdir(ROOT)
    with pytest.raises(SystemExit) as info:
        main(_train_argv(tmp_path / "ckpt", corpus, "mbt2018", 2, "--retries", "1"))
    assert info.value.code == 0
    assert os.path.exists(tmp_path / "ckpt" / RUN / "params-2.npz")


_IMPORT_CHECK = r"""
import json, pkgutil, importlib, sys
import nic_tpu_torch
names = ["nic_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    nic_tpu_torch.__path__, "nic_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "nic_tpu"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_neither_jax_nor_nic_tpu():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "nic_tpu_torch.infer.engine" in report["modules"]
    assert "nic_tpu_torch.cli.main" in report["modules"]
    assert "nic_tpu_torch.parallel.mesh" in report["modules"]
    assert "nic_tpu_torch.parallel.spatial" in report["modules"]
    assert report["bad"] == []


def _imported_roots(path):
    tree = ast.parse(open(path).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_sources_name_neither_jax_nor_nic_tpu():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "nic_tpu_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    for p in paths:
        assert not _imported_roots(p) & {"jax", "jaxlib", "flax", "nic_tpu"}, p


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    """No card here: the script exits non-zero and prints no result; alone in
    a directory it fails too."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), lone)
    for cwd, script in ((ROOT, os.path.join(ROOT, "chip_smoke.py")),
                        (tmp_path, str(lone))):
        proc = subprocess.run([sys.executable, script], cwd=cwd, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
