"""The bits-back family of the port against nic_tpu's, on the CPU: the
BitsBackHyperprior model (every output of the evaluation forward, the
prior's pdf and its gradient), the two-phase engine (bb_sga, bb_no_sga,
bb_plain), the npz loader's model check, the CLI's bits-back scripts and
the bf16 forward.

JAX and torch draw different random numbers, so the port is fed JAX's
draws, made the way nic_tpu's engine makes them (``jax_bb_noise_fn``):
phase 1 starts from PRNGKey(seed) and each step splits (key, sub), then sub
into (k_sga, k_eps) for the Gumbel pair of y and the normal draw of z;
phase 2 starts again from PRNGKey(seed) and draws its normal from each
step's sub; the evaluation sample draws from PRNGKey(seed + 1). The eval
forward of the model draws from split(rng)[0].

Tolerances, elementwise with an absolute floor of the same fraction of the
largest reference magnitude: float32 values 1e-5 relative, gradients 1e-4;
y* rounds exactly. Through the CLI, whose loops run 1000 (bb_no_sga) and
2003 (bb_sga) Adam steps, 1e-4. The bf16 forward against nic_tpu's bf16
model (whose GDN is XLA's, which rounds the normalizer to bf16 by design)
with tests/test_torch_bf16.py's limits for that route: est. bpp 0.5 %, y
1e-2, x_tilde 0.1, and at least 99 % of the transmitted round(y) equal.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from nic_tpu.cli.main import main as jax_main
from nic_tpu.infer import bb as jax_bb
from nic_tpu.models.mbt2018 import MeanScaleHyperprior as JaxMBT
from nic_tpu.models.mbt2018_bb import BitsBackHyperprior as JaxBB
from nic_tpu.train.checkpoint import load_params_npz as jax_load_params_npz
from nic_tpu_torch.checkpoint import latest_npz, load_model, load_params_npz, params_from_jax
from nic_tpu_torch.cli.main import main
from nic_tpu_torch.evaluation.results import rd_results_filename
from nic_tpu_torch.infer import bb
from nic_tpu_torch.models.mbt2018_bb import BitsBackHyperprior

torch.set_num_threads(1)

VALUE_RTOL = 1e-5
GRAD_RTOL = 1e-4
CLI_RTOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT_DIR = os.path.join(ROOT, "checkpoints_synth3")
RUN = "mbt2018_bb-num_filters=192-lmbda=0.01"
SMALL_RUN = "mbt2018_bb-num_filters=8-lmbda=0.01"
PHOTOS = os.path.join(ROOT, "data_real", "eval_photos.npy")
OUTPUT_KEYS = ("y", "z_mean", "z_logvar", "z_tilde", "log_q_z_tilde", "z_likelihoods",
               "mu", "sigma", "y_tilde", "y_likelihoods", "x_tilde")
METRIC_KEYS = ("mse", "psnr", "est_bpp", "est_y_bpp", "est_z_bpp", "est_bpp_back",
               "x_tilde")
BB_FIELDS = ("mse", "psnr", "msssim", "msssim_db", "est_bpp", "est_y_bpp",
             "est_z_bpp", "est_bpp_back")


def assert_rel(actual, expected, rtol=VALUE_RTOL):
    actual = np.asarray(actual, np.float64)
    expected = np.asarray(expected, np.float64)
    floor = rtol * max(float(np.nanmax(np.abs(expected), initial=0.0)), 1e-30)
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=floor)


def jax_bb_noise_fn(seed, rd_steps, rate_steps):
    """The port's noise_fn giving nic_tpu's draws of each phase and of the
    evaluation sample."""
    keys = {}
    key = jax.random.PRNGKey(seed)
    for it in range(rd_steps):
        key, sub = jax.random.split(key)
        k_sga, k_eps = jax.random.split(sub)
        keys[(1, it)] = {"gumbel": k_sga, "eps": k_eps}
    key = jax.random.PRNGKey(seed)
    for it in range(rate_steps):
        key, sub = jax.random.split(key)
        keys[(2, it)] = {"eps": sub}
    keys[None] = {"eps": jax.random.PRNGKey(seed + 1)}

    def fn(step, name, shape):
        draw = jax.random.gumbel if name == "gumbel" else jax.random.normal
        return torch.tensor(np.asarray(draw(keys[step][name], shape)))

    return fn


def _flat(params):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(params, sep="/").items()}


def _jax_init(num_filters, model=JaxBB):
    return model(num_filters=num_filters).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), training=True,
        rng=jax.random.PRNGKey(1))["params"]


def _port_model(flat, dtype=torch.float32):
    model = BitsBackHyperprior(flat["analysis/layer_0/kernel"].shape[-1], dtype)
    model.load_state_dict(params_from_jax(flat, "mbt2018_bb"))
    return model.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def small():
    """nic_tpu's nf=16 bits-back model, JAX-initialized, and the port's."""
    params = _jax_init(16)
    return JaxBB(num_filters=16), params, _port_model(_flat(params))


@pytest.fixture(scope="module")
def committed():
    """The committed nf=192 lambda=0.01 bits-back checkpoint on both sides."""
    path = latest_npz(os.path.join(CKPT_DIR, RUN))
    _, params = jax_load_params_npz(path)
    return JaxBB(num_filters=192), params, _port_model(load_params_npz(path)[1])


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(7).random((2, 64, 64, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def crop():
    return np.load(PHOTOS)[:1, 100:164, 200:264].astype(np.float32) / 255.0


# ------------------------------------------------------------------ model


@pytest.mark.parametrize("which,data", [("small", "image"), ("committed", "crop")])
def test_eval_forward_matches(request, which, data):
    """Every output of the evaluation forward, the port fed the eps that
    nic_tpu's forward draws."""
    jmodel, params, model = request.getfixturevalue(which)
    x = request.getfixturevalue(data)
    rng = jax.random.PRNGKey(3)
    ref = jmodel.apply({"params": params}, jnp.asarray(x), training=False, rng=rng)
    eps = torch.tensor(np.asarray(jax.random.normal(jax.random.split(rng)[0],
                                                    ref["z_mean"].shape)))
    with torch.no_grad():
        out = model(torch.tensor(x), eps)
    assert set(out) == set(ref)
    for k in OUTPUT_KEYS:
        assert tuple(out[k].shape) == ref[k].shape, k
        assert_rel(out[k], ref[k])


@pytest.mark.parametrize("which", ["small", "committed"])
def test_hyper_prior_pdf_and_its_gradient(request, which):
    """The prior's pdf (forward-mode derivative of the CDF) and the gradient
    of sum(log pdf) with respect to z, reverse mode through the pdf's
    forward mode, against jax.grad. The committed prior's tanh factors are
    nonzero, so its second derivative is not trivial."""
    jmodel, params, model = request.getfixturevalue(which)
    n = model.num_filters
    z = (3.0 * np.random.default_rng(5).standard_normal((2, 4, 4, n))).astype(np.float32)

    def jlogpdf(v):
        pdf = jmodel.apply({"params": params}, v, method=jmodel.hyper_prior_pdf)
        return jnp.sum(jnp.log(pdf)), pdf

    (_, ref), ref_grad = jax.value_and_grad(jlogpdf, has_aux=True)(jnp.asarray(z))
    zt = torch.tensor(z, requires_grad=True)
    pdf = model.hyper_prior_pdf(zt)
    (grad,) = torch.autograd.grad(torch.sum(torch.log(pdf)), zt)
    assert_rel(pdf.detach(), ref)
    assert_rel(grad, ref_grad, GRAD_RTOL)


def test_params_from_jax_checks_the_model(committed):
    _, _, model = committed
    _, flat = load_params_npz(latest_npz(os.path.join(CKPT_DIR, RUN)))
    with pytest.raises(KeyError, match="a mbt2018_bb parameter set, not mbt2018"):
        params_from_jax(flat)
    mbt = _flat(_jax_init(8, JaxMBT))
    with pytest.raises(KeyError, match="a mbt2018 parameter set, not mbt2018_bb"):
        params_from_jax(mbt, "mbt2018_bb")
    with pytest.raises(ValueError, match="unknown model"):
        params_from_jax(flat, "bb")
    missing = dict(flat)
    del missing["hyper_prior/factor_0"]
    with pytest.raises(KeyError, match="missing"):
        params_from_jax(missing, "mbt2018_bb")
    bad = dict(flat, **{"hyper_analysis/layer_2/kernel": np.zeros((5, 5, 192, 192))})
    with pytest.raises(ValueError, match="does not fit"):
        params_from_jax(bad, "mbt2018_bb")
    assert tuple(model.hyper_analysis.layer_2.weight.shape) == (384, 192, 5, 5)
    _, loaded = load_model(CKPT_DIR, RUN, 192, "cpu", model="mbt2018_bb")
    assert isinstance(loaded, BitsBackHyperprior)
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


def test_training_is_refused_with_the_roadmap(small):
    """A training forward with no source of noise is refused (nic_tpu's
    "training=True requires rng"); given its draws it runs, crops nothing
    and bounds sigma by sqrt(VARIANCE_UPPER_BOUND_BB_TRAIN)."""
    _, _, model = small
    x = torch.zeros(1, 64, 64, 3)
    with pytest.raises(ValueError, match="generator"):
        model(x, torch.zeros(1, 1, 1, 16), training=True)
    with pytest.raises(ValueError, match="eps or a generator"):
        model(x, training=True)
    out = model(x, torch.zeros(1, 1, 1, 16), training=True,
                noise=torch.zeros(1, 4, 4, 16))
    assert out["x_tilde"].shape == (1, 64, 64, 3) and out["mu"].shape == (1, 4, 4, 16)
    z = 1e3 * torch.ones(1, 1, 1, 16)
    sigma = model.hyper_synthesize(z, training=True)[1]
    bound = float(np.float32(10.0 ** 0.5))
    assert float(sigma.max()) <= bound < float(model.hyper_synthesize(z)[1].max())


# ----------------------------------------------------------------- engine


def test_specs_match_nic_tpu():
    for name, ref in (("bb_sga", jax_bb.BB_SGA), ("bb_no_sga", jax_bb.BB_NO_SGA),
                      ("bb_plain", jax_bb.BB_PLAIN)):
        assert vars(bb.BB_METHODS[name]) == vars(ref)


def _run_both(small, image, jspec, spec, seed=0):
    jmodel, params, model = small
    ref = jax_bb.BBLatentOptimizer(jmodel, params).optimize(image, 0.01, spec=jspec,
                                                            seed=seed)
    opt = bb.BBLatentOptimizer(model, "cpu")
    out = opt.optimize(image, 0.01, spec=spec, seed=seed, noise_fn=jax_bb_noise_fn(
        seed, spec.rd_iterations, spec.rate_iterations))
    return ref, out, opt


def test_two_phase_steps_match_jax(small, image):
    """k steps of phase 1 (SGA on y, Adam on y and the posterior) and of
    phase 2 (rate-only, on the posterior): every step's loss, y*, the final
    posterior and the evaluation."""
    kw = dict(rd_iterations=4, rate_iterations=3)
    ref, out, opt = _run_both(small, image, jax_bb.BBMethodSpec(name="bb_sga", **kw),
                              bb.BB_SGA.replace(**kw), seed=2)
    assert set(out) == set(ref)
    assert out["rd_losses"].shape == (4,) and out["rate_losses"].shape == (3,)
    assert_rel(out["rd_losses"], ref["rd_losses"])
    assert_rel(out["rate_losses"], ref["rate_losses"])
    np.testing.assert_array_equal(out["y"], ref["y"])
    assert_rel(out["z_mean"], ref["z_mean"])
    assert_rel(out["z_logvar"], ref["z_logvar"])
    for k in METRIC_KEYS:
        assert_rel(out[k], ref[k])
    t = opt.last_timing
    assert (t["rd_steps"], t["rate_steps"]) == (4, 3) and t["rd_ms"] > 0 and t["rate_ms"] > 0


@pytest.mark.parametrize("name,kw", [("bb_plain", {}), ("bb_no_sga", {"rate_iterations": 5})])
def test_plain_and_no_sga_match_jax(small, image, name, kw):
    jspec = dataclasses.replace(getattr(jax_bb, name.upper()), **kw)
    ref, out, _ = _run_both(small, image, jspec, bb.BB_METHODS[name].replace(**kw))
    assert set(out) == set(ref)
    assert out["rd_losses"].shape == (0,)
    assert_rel(out["rate_losses"], ref["rate_losses"])
    np.testing.assert_array_equal(out["y"], ref["y"])
    for k in ("z_mean", "z_logvar") + METRIC_KEYS:
        assert_rel(out[k], ref[k])


def test_noise_comes_from_the_seed(small, image):
    """Without injected draws the generator's seed decides them: the same
    seed gives the same run, another seed another."""
    _, _, model = small
    opt = bb.BBLatentOptimizer(model, "cpu")
    spec = bb.BB_SGA.replace(rd_iterations=2, rate_iterations=3)
    a = opt.optimize(image, 0.01, spec, seed=3)
    b = opt.optimize(image, 0.01, spec, seed=3)
    c = opt.optimize(image, 0.01, spec, seed=4)
    for k in ("rd_losses", "rate_losses", "est_bpp"):
        np.testing.assert_array_equal(a[k], b[k])
        assert not np.array_equal(a[k], c[k])
    opt.optimize(image, 0.01, bb.BB_NO_SGA.replace(rate_iterations=3), seed=3)
    assert (opt.last_timing["rd_steps"], opt.last_timing["rate_steps"]) == (0, 3)


# -------------------------------------------------------------------- CLI


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A JAX-initialized nf=8 bits-back checkpoint and two 64x64 photo crops."""
    d = tmp_path_factory.mktemp("bbcli")
    run_dir = d / "ckpt" / SMALL_RUN
    run_dir.mkdir(parents=True)
    np.savez(run_dir / "params-0.npz", **_flat(_jax_init(8)))
    np.save(d / "crops.npy", np.load(PHOTOS)[:2, 100:164, 200:264])
    return d


def _argv(workdir, script, results, *extra):
    return ["--num_filters", "8", "--checkpoint_dir", str(workdir / "ckpt"), script,
            "compress", SMALL_RUN, str(workdir / "crops.npy"), "--results_dir",
            str(results), *extra]


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's CLI fed nic_tpu's draws of each run."""
    optimize = bb.BBLatentOptimizer.optimize

    def with_jax_draws(self, x, lmbda, spec=bb.BB_SGA, seed=0, noise_fn=None):
        fn = jax_bb_noise_fn(seed, spec.rd_iterations, spec.rate_iterations)
        return optimize(self, x, lmbda, spec, seed, fn)

    monkeypatch.setattr(bb.BBLatentOptimizer, "optimize", with_jax_draws)


@pytest.mark.parametrize("script,extra", [("bb_plain", ()), ("bb_no_sga", ()),
                                          ("bb_sga", ("--sga_its", "3", "--seed", "1"))])
def test_compress_matches_jax_cli(workdir, jax_draws, capsys, script, extra):
    """Both CLIs on the same checkpoint, crops and draws write the same
    rd-*.npz fields; the port's stream decodes exactly, with its initial
    bits back."""
    stream = workdir / f"{script}.ntc"
    jax_main(_argv(workdir, script, workdir / f"res_jax_{script}", *extra))
    out = main(["--device", "cpu"] + _argv(workdir, script, workdir / f"res_{script}",
                                           str(stream), *extra))
    name = rd_results_filename(script, SMALL_RUN, "crops.npy", 0.01)
    ref = np.load(workdir / f"res_jax_{script}" / name)
    got = np.load(workdir / f"res_{script}" / name)
    assert set(got.files) == set(ref.files) == set(BB_FIELDS)
    for k in BB_FIELDS:
        assert got[k].shape == ref[k].shape == (2,)
        assert_rel(got[k], ref[k], CLI_RTOL)
    steps = {"bb_plain": (0, 0), "bb_no_sga": (0, 1000), "bb_sga": (3, 2000)}[script]
    assert [(t["rd_steps"], t["rate_steps"]) for t in out["timing"]] == [steps]
    printed = capsys.readouterr().out
    assert f"Wrote {stream}: {out['bytes']} bytes (actual" in printed
    assert ("posterior deltas" in printed) == (script != "bb_plain")
    assert out["bytes"] == stream.stat().st_size

    png = workdir / f"{script}.png"
    dec = main(["--device", "cpu", "--num_filters", "8", "--checkpoint_dir",
                str(workdir / "ckpt"), script, "decompress", SMALL_RUN, str(stream),
                str(png)])
    got = np.round(dec["x_hat"] * 255.0).astype(np.uint8)
    np.testing.assert_array_equal(got, out["pixels"])
    assert png.exists()


def test_decompress_exits_nonzero_when_the_bits_do_not_come_back(workdir):
    from nic_tpu_torch.coding.container import PackedBitstream

    stream = workdir / "bb_plain_seed.ntc"
    main(["--device", "cpu"] + _argv(workdir, "bb_plain", workdir / "res_seed",
                                     str(stream)))
    packed = PackedBitstream.unpack(stream.read_bytes())
    packed.add_ints("seed", [packed.get_ints("seed")[0] + 1])
    stream.write_bytes(packed.pack())
    with pytest.raises(SystemExit) as info:
        main(["--device", "cpu", "--num_filters", "8", "--checkpoint_dir",
              str(workdir / "ckpt"), "bb_plain", "decompress", SMALL_RUN, str(stream)])
    assert "bits-back integrity check failed" in str(info.value.code)


@pytest.mark.parametrize("script", ["bb_sga", "bb_no_sga", "bb_plain"])
def test_bits_back_scripts_raise_without_a_card(workdir, monkeypatch, script):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(_argv(workdir, script, workdir / "res_nocard"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bb.BBLatentOptimizer(BitsBackHyperprior(8))


# ------------------------------------------------------------------- bf16


def test_bf16_forward_near_nic_tpus_bf16_model(committed, crop):
    _, params, _ = committed
    model = _port_model(load_params_npz(latest_npz(os.path.join(CKPT_DIR, RUN)))[1],
                        torch.bfloat16)
    jmodel = JaxBB(num_filters=192, compute_dtype=jnp.bfloat16)
    rng = jax.random.PRNGKey(4)
    ref = jmodel.apply({"params": params}, jnp.asarray(crop), training=False, rng=rng)
    eps = torch.tensor(np.asarray(jax.random.normal(jax.random.split(rng)[0],
                                                    ref["z_mean"].shape)))
    with torch.no_grad():
        out = model(torch.tensor(crop), eps)

    def net_bpp(o):
        bits = (np.sum(np.log(np.asarray(o["y_likelihoods"], np.float64)))
                + np.sum(np.log(np.asarray(o["z_likelihoods"], np.float64)))
                - np.sum(np.asarray(o["log_q_z_tilde"], np.float64)))
        return -bits / (np.log(2.0) * 64 * 64)

    for k in OUTPUT_KEYS:
        assert out[k].dtype == torch.float32 and tuple(out[k].shape) == ref[k].shape, k
    assert abs(net_bpp(out) - net_bpp(ref)) <= 0.005 * net_bpp(ref)
    y, y_ref = out["y"].numpy(), np.asarray(ref["y"])
    assert np.abs(y - y_ref).max() <= 1e-2 * np.abs(y_ref).max()
    x, x_ref = out["x_tilde"].numpy(), np.asarray(ref["x_tilde"])
    assert np.abs(x - x_ref).max() <= 0.1 * np.abs(x_ref).max()
    assert np.mean(np.round(y) == np.round(y_ref)) >= 0.99
