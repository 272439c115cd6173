"""The map, ste, unoise and danneal methods of the port against nic_tpu's,
on the CPU: the schedules, the STE rounds, the annealing relaxation, k
steps of each method, the early stop of map and ste, the transmitted
latents, the --verbose probes, the msssim objective and MS-SSIM itself.

JAX and torch draw different random numbers, so the port is fed JAX's
draws, reproduced the way nic_tpu's engine makes them (see
``test_torch_engine.jax_step_keys``): unoise adds jax.random.uniform(key,
v.shape, -0.5, 0.5) with ky for y and kz for z, and its "noisy_z" transmit
draw uses fold_in(PRNGKey(seed), 0x7A31).

Tolerances: float32 values 1e-5 relative, gradients 1e-4, elementwise with
an absolute floor of the same fraction of the largest reference magnitude;
the STE rounds exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from nic_tpu.evaluation.metrics import msssim as jax_msssim
from nic_tpu.infer import engine as jax_engine
from nic_tpu.infer.methods import METHODS as JAX_METHODS
from nic_tpu.ops import quantize as jax_quantize
from nic_tpu.ops import schedules as jax_schedules
from nic_tpu.models.mbt2018 import MeanScaleHyperprior as JaxMBT
from nic_tpu_torch.checkpoint import params_from_jax
from nic_tpu_torch.evaluation.metrics import msssim
from nic_tpu_torch.infer.engine import (
    TRANSMIT_SEED_OFFSET,
    LatentOptimizer,
    Latents,
    _quantize_transmitted,
    _rd_loss,
)
from nic_tpu_torch.infer.methods import METHODS
from nic_tpu_torch.models.mbt2018 import MeanScaleHyperprior
from nic_tpu_torch.ops import quantize, schedules

from test_torch_engine import jax_gumbel_fn, jax_step_keys

torch.set_num_threads(1)

VALUE_RTOL = 1e-5
GRAD_RTOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHOTOS = os.path.join(ROOT, "data_real", "eval_photos.npy")
METRIC_KEYS = ("mse", "psnr", "est_bpp", "est_y_bpp", "est_z_bpp", "x_tilde")


def assert_rel(actual, expected, rtol=VALUE_RTOL):
    actual = np.asarray(actual, np.float64)
    expected = np.asarray(expected, np.float64)
    floor = rtol * max(float(np.nanmax(np.abs(expected), initial=0.0)), 1e-30)
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=floor)


def jax_uniform_fn(seed, steps):
    """unoise's draws of each step, and its transmit draw (step None)."""
    keys = jax_step_keys(seed, steps)
    transmit = jax.random.fold_in(jax.random.PRNGKey(seed), 0x7A31)

    def fn(step, name, shape):
        key = transmit if step is None else keys[step][1][name]
        return torch.tensor(np.asarray(
            jax.random.uniform(key, shape, jnp.float32, -0.5, 0.5)))

    return fn


def _optimizers(num_filters):
    """nic_tpu's and the port's engines on one JAX-initialized model."""
    jmodel = JaxMBT(num_filters=num_filters)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                         training=True, rng=jax.random.PRNGKey(1))["params"]
    flat = {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(params, sep="/").items()}
    model = MeanScaleHyperprior(num_filters)
    model.load_state_dict(params_from_jax(flat))
    return jax_engine.LatentOptimizer(jmodel, params), LatentOptimizer(model, "cpu")


@pytest.fixture(scope="module")
def models():
    return _optimizers(16)


@pytest.fixture(scope="module")
def models8():
    return _optimizers(8)


@pytest.fixture(scope="module")
def image():
    """Two 64x64 crops of the real photos."""
    return np.load(PHOTOS)[:2, 100:164, 200:264].astype(np.float32) / 255.0


# ------------------------------------------------------------------- ops


@pytest.mark.parametrize("scheme,kw", [
    ("exp", dict(r=4e-3, ub=0.2)),
    ("exp0", dict(r=1e-3, ub=0.5, t0=700)),
    ("linear", dict(r=2e-4, ub=0.5, t0=700)),
])
def test_annealed_temperature_schemes(scheme, kw):
    t = np.arange(2001)
    ref = np.asarray(jax_schedules.annealed_temperature(jnp.asarray(t), scheme=scheme, **kw))
    out = [schedules.annealed_temperature(int(i), scheme=scheme, **kw) for i in t]
    assert_rel(out, ref)


@pytest.mark.parametrize("name", ["round_ste", "round_relu_ste", "round_crelu_ste"])
def test_ste_rounds_forward_and_gradient(name):
    rng = np.random.default_rng(3)
    # Ties at .5 round to even in both.
    x = np.concatenate([rng.normal(0, 3, 60), [-2.5, -1.5, -0.5, 0.5, 1.5, 2.5]])
    x = x.astype(np.float32)
    g = rng.normal(0, 2, x.shape).astype(np.float32)
    ref, vjp = jax.vjp(getattr(jax_quantize, name), jnp.asarray(x))
    (ref_grad,) = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    out = getattr(quantize, name)(xt)
    (grad,) = torch.autograd.grad(out, xt, torch.tensor(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    np.testing.assert_array_equal(grad.numpy(), np.asarray(ref_grad))


@pytest.mark.parametrize("temperature", [0.2, 0.01])
def test_danneal_relax(temperature):
    rng = np.random.default_rng(4)
    v = rng.normal(0, 3, (4, 5, 6)).astype(np.float32)
    g = rng.normal(0, 1, v.shape).astype(np.float32)
    ref, vjp = jax.vjp(lambda a: jax_quantize.danneal_relax(a, temperature), jnp.asarray(v))
    (ref_grad,) = vjp(jnp.asarray(g))
    vt = torch.tensor(v, requires_grad=True)
    out = quantize.danneal_relax(vt, temperature)
    (grad,) = torch.autograd.grad(out, vt, torch.tensor(g))
    assert_rel(out.detach(), ref)
    assert_rel(grad, ref_grad, GRAD_RTOL)


def test_uniform_noise_draws_and_injection():
    v = torch.zeros(100000)
    a = quantize.uniform_noise(v, generator=torch.Generator().manual_seed(5))
    b = quantize.uniform_noise(v, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(a.min()) >= -0.5 and float(a.max()) < 0.5
    assert abs(float(a.mean())) < 0.01
    key = jax.random.PRNGKey(2)
    x = np.random.default_rng(1).normal(0, 2, (3, 7)).astype(np.float32)
    ref = jax_quantize.uniform_noise(jnp.asarray(x), key)
    draws = jax.random.uniform(key, x.shape, jnp.float32, -0.5, 0.5)
    out = quantize.uniform_noise(torch.tensor(x), noise=torch.tensor(np.asarray(draws)))
    assert_rel(out, ref)
    with pytest.raises(ValueError, match="generator"):
        quantize.uniform_noise(v)


def test_method_specs_match_nic_tpu():
    assert set(METHODS) == set(JAX_METHODS)
    for name, spec in METHODS.items():
        assert vars(spec) == vars(JAX_METHODS[name]), name


# ---------------------------------------------------------------- engine


def _noise_fn(method, seed, steps):
    return jax_uniform_fn(seed, steps) if method == "unoise" else None


@pytest.mark.parametrize("method,mu_source", [
    ("map", "quantized_z"),
    ("ste", "quantized_z"),
    ("unoise", "quantized_z"),
    ("unoise", "noisy_z"),
    ("danneal", "quantized_z"),
])
def test_method_steps_match_jax(models, image, method, mu_source):
    """k steps of each method with the early stop off: the loss of each
    step, the transmitted latents and the eval metrics."""
    jopt, opt = models
    steps = 8
    spec = dict(iterations=steps, early_stop=False, unoise_mu_source=mu_source)
    ref = jopt.optimize(image, 0.01, method=JAX_METHODS[method].replace(**spec), seed=1)
    out = opt.optimize(image, 0.01, method=METHODS[method].replace(**spec), seed=1,
                       noise_fn=_noise_fn(method, 1, steps))
    assert set(out) == set(ref)
    assert out["losses"].shape == (steps,)
    assert_rel(out["losses"], ref["losses"])
    assert np.all(np.isnan(out["rounded_losses"]))
    assert_rel(out["y"], ref["y"])
    assert_rel(out["z"], ref["z"])
    for k in METRIC_KEYS:
        assert_rel(out[k], ref[k])
    assert opt.last_timing["steps"] == steps


def _jax_stop_step(jopt, image, spec):
    """The step at which nic_tpu's while loop stopped (its carry's it)."""
    x = jnp.asarray(image)
    y0, z0 = jax_engine._amortized_init(jopt.model, jopt.params, x)
    carry = jax_engine._init_carry(jax_engine.Latents(y0, z0), jax.random.PRNGKey(0))
    carry, _, _ = jax_engine._optimize_chunk(
        jopt.model, jopt.params, x, jnp.float32(0.01), spec, spec.iterations, carry, 0, 1)
    return int(carry.it), bool(carry.stopped)


@pytest.mark.parametrize("method,fixture,stop", [("map", "models8", 41),
                                                 ("ste", "models", 61)])
def test_early_stop_step_and_saved_latents_match_jax(request, image, method, fixture,
                                                     stop):
    """The specs' own settings on models where the probe worsens early (map
    at nf=8, ste at nf=16): both stop at the same step and transmit the
    latents of the last improving probe."""
    jopt, opt = request.getfixturevalue(fixture)
    stop_step, stopped = _jax_stop_step(jopt, image, JAX_METHODS[method])
    assert stopped and stop_step == stop
    ref = jopt.optimize(image, 0.01, method=JAX_METHODS[method], seed=0)
    out = opt.optimize(image, 0.01, method=METHODS[method], seed=0)
    assert opt.last_timing["steps"] == stop_step
    assert out["losses"].shape == out["rounded_losses"].shape == (0,)
    assert ref["losses"].shape == (0,)
    assert_rel(out["y"], ref["y"])
    assert_rel(out["z"], ref["z"])
    for k in METRIC_KEYS:
        assert_rel(out[k], ref[k])


def test_early_stop_runs_to_the_end_without_a_worse_probe(models, image):
    """Fewer steps than the stop takes: the last step is probed, and the
    final latents (not the saved ones) are transmitted, as in nic_tpu."""
    jopt, opt = models
    ref = jopt.optimize(image, 0.01, method=JAX_METHODS["map"].replace(iterations=12), seed=0)
    out = opt.optimize(image, 0.01, method=METHODS["map"].replace(iterations=12), seed=0)
    assert opt.last_timing["steps"] == 12
    assert_rel(out["y"], ref["y"])
    assert_rel(out["z"], ref["z"])


@pytest.mark.parametrize("method,mu_source", [
    ("map", "quantized_z"), ("unoise", "quantized_z"), ("unoise", "noisy_z"),
    ("sga", "quantized_z"),
])
def test_quantize_transmitted_matches_jax(models, image, method, mu_source):
    jopt, opt = models
    y0, z0 = (np.asarray(a) for a in jopt.amortized_init(image))
    rng = np.random.default_rng(9)
    y = y0 + rng.uniform(-0.4, 0.4, y0.shape).astype(np.float32)
    z = z0 + rng.uniform(-0.4, 0.4, z0.shape).astype(np.float32)
    key = jax.random.PRNGKey(11)
    ref = jax_engine._quantize_transmitted(
        jopt.model, jopt.params, jax_engine.Latents(jnp.asarray(y), jnp.asarray(z)),
        method, key, mu_source)
    draw = torch.tensor(np.asarray(jax.random.uniform(key, z.shape, jnp.float32, -0.5, 0.5)))
    out = _quantize_transmitted(opt.model, Latents(torch.tensor(y), torch.tensor(z)), method,
                                mu_source, draw)
    assert_rel(out.y, ref.y)
    assert_rel(out.z, ref.z)


def test_noisy_z_transmit_draw_comes_from_the_seed(models, image):
    _, opt = models
    spec = METHODS["unoise"].replace(iterations=2, unoise_mu_source="noisy_z")
    a = opt.optimize(image, 0.01, method=spec, seed=3)
    b = opt.optimize(image, 0.01, method=spec, seed=3)
    c = opt.optimize(image, 0.01, method=spec, seed=3 + TRANSMIT_SEED_OFFSET)
    np.testing.assert_array_equal(a["y"], b["y"])
    assert not np.array_equal(a["y"], c["y"])


def test_verbose_probes_of_sga_match_jax(models, image):
    jopt, opt = models
    steps, every = 7, 3
    ref = jopt.optimize(image, 0.01, method=JAX_METHODS["sga"].replace(iterations=steps),
                        seed=0, probe_every=every)
    out = opt.optimize(image, 0.01, method=METHODS["sga"].replace(iterations=steps),
                       seed=0, noise_fn=jax_gumbel_fn(0, steps), probe_every=every)
    probed = np.arange(steps) % every == 0
    assert np.all(np.isfinite(out["rounded_losses"][probed]))
    assert np.all(np.isnan(out["rounded_losses"][~probed]))
    np.testing.assert_array_equal(np.isnan(ref["rounded_losses"]), ~probed)
    assert_rel(out["rounded_losses"][probed], ref["rounded_losses"][probed])
    assert_rel(out["losses"], ref["losses"])


# ------------------------------------------------------------ MS-SSIM


def test_msssim_matches_jax_on_noisy_photo_crops():
    x = np.load(PHOTOS)[:3, 96:288, 128:384].astype(np.float32)
    noisy = np.clip(x + np.random.default_rng(0).normal(0, 8, x.shape), 0, 255)
    noisy = noisy.astype(np.float32)
    ref = np.asarray(jax_msssim(jnp.asarray(noisy), jnp.asarray(x), 255.0))
    out = msssim(torch.tensor(noisy), torch.tensor(x), 255.0)
    assert out.shape == (3,) and np.all(np.isfinite(out.numpy()))
    assert_rel(out, ref)


def test_msssim_objective_value_and_gradient(models):
    """The msssim distortion in the loss is differentiable in torch and
    agrees with nic_tpu's, value and latent gradient."""
    jopt, opt = models
    x = np.load(PHOTOS)[:1, :192, :192].astype(np.float32) / 255.0
    y0, z0 = (np.asarray(a) for a in jopt.amortized_init(x))
    sub, _ = jax_step_keys(0, 1)[0]

    def jloss(lat):
        return jax_engine._rd_loss(jopt.model, jopt.params, lat, jnp.asarray(x), 0.01,
                                   0.2, sub, "danneal", "msssim")

    (ref, _), ref_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax_engine.Latents(jnp.asarray(y0), jnp.asarray(z0)))
    yt = torch.tensor(y0, requires_grad=True)
    zt = torch.tensor(z0, requires_grad=True)
    loss, _ = _rd_loss(opt.model, Latents(yt, zt), torch.tensor(x), 0.01, 0.2, "danneal",
                       distortion="msssim")
    gy, gz = torch.autograd.grad(loss, (yt, zt))
    assert_rel(loss.detach(), ref)
    assert_rel(gy, ref_grads.y, GRAD_RTOL)
    assert_rel(gz, ref_grads.z, GRAD_RTOL)


def test_msssim_objective_refuses_small_images(models, image):
    _, opt = models
    spec = METHODS["sga"].replace(iterations=1, distortion="msssim")
    with pytest.raises(ValueError, match="176"):
        opt.optimize(image, 0.01, method=spec)
