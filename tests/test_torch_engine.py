"""The port's SGA engine against nic_tpu's, on the CPU.

JAX and torch draw different random numbers, so the port is fed JAX's
Gumbel draws, reproduced the way nic_tpu's engine makes them: the loop's
key starts as PRNGKey(seed) (engine.py LatentOptimizer.optimize), each step
splits it into (next, sub) (_optimize_chunk_impl.common_step), _forward
splits sub into (ky, kz), and sga_relax draws jax.random.gumbel(key,
v.shape + (2,)).

Tolerances: float32 values 1e-5 relative, gradients 1e-4, elementwise with
an absolute floor of the same fraction of the largest reference magnitude.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from nic_tpu.infer.engine import LatentOptimizer as JaxLatentOptimizer
from nic_tpu.infer.engine import Latents as JaxLatents
from nic_tpu.infer.engine import _rd_loss as jax_rd_loss
from nic_tpu.infer.methods import SGA as JAX_SGA
from nic_tpu.models.mbt2018 import MeanScaleHyperprior as JaxMBT
from nic_tpu_torch.checkpoint import load_model, params_from_jax
from nic_tpu_torch.infer.engine import LatentOptimizer, Latents, _rd_loss
from nic_tpu_torch.infer.methods import SGA, get_method
from nic_tpu_torch.models.mbt2018 import MeanScaleHyperprior

torch.set_num_threads(1)

VALUE_RTOL = 1e-5
GRAD_RTOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC_KEYS = ("mse", "psnr", "est_bpp", "est_y_bpp", "est_z_bpp", "x_tilde")


def assert_rel(actual, expected, rtol=VALUE_RTOL):
    actual = np.asarray(actual, np.float64)
    expected = np.asarray(expected, np.float64)
    floor = rtol * max(float(np.abs(expected).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=floor)


def jax_step_keys(seed, steps):
    """[(ky, kz)] of each step, as nic_tpu's engine derives them."""
    rng = jax.random.PRNGKey(seed)
    keys = []
    for _ in range(steps):
        rng, sub = jax.random.split(rng)
        ky, kz = jax.random.split(sub)
        keys.append((sub, {"y": ky, "z": kz}))
    return keys


def jax_gumbel_fn(seed, steps):
    keys = jax_step_keys(seed, steps)

    def fn(step, name, shape):
        return torch.tensor(np.asarray(jax.random.gumbel(keys[step][1][name], shape)))

    return fn


@pytest.fixture(scope="module")
def models():
    jmodel = JaxMBT(num_filters=16)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                         training=True, rng=jax.random.PRNGKey(1))["params"]
    flat = {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(params, sep="/").items()}
    model = MeanScaleHyperprior(16)
    model.load_state_dict(params_from_jax(flat))
    return JaxLatentOptimizer(jmodel, params), LatentOptimizer(model, "cpu")


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(7).random((2, 64, 64, 3)).astype(np.float32)


@pytest.mark.parametrize("temperature,step", [(0.5, 0), (0.2, 3)])
def test_rd_loss_value_and_latent_gradient(models, image, temperature, step):
    jopt, opt = models
    y0, z0 = jopt.amortized_init(image)
    rng = np.random.default_rng(step)
    y = np.asarray(y0) + rng.uniform(-0.3, 0.3, y0.shape).astype(np.float32)
    z = np.asarray(z0) + rng.uniform(-0.3, 0.3, z0.shape).astype(np.float32)
    sub, _ = jax_step_keys(0, step + 1)[step]

    def jloss(lat):
        return jax_rd_loss(jopt.model, jopt.params, lat, jnp.asarray(image), 0.01,
                           temperature, sub, "sga")

    (ref, ref_aux), ref_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        JaxLatents(jnp.asarray(y), jnp.asarray(z)))

    gumbel = jax_gumbel_fn(0, step + 1)
    yt = torch.tensor(y, requires_grad=True)
    zt = torch.tensor(z, requires_grad=True)
    noise = Latents(y=gumbel(step, "y", y.shape + (2,)), z=gumbel(step, "z", z.shape + (2,)))
    loss, aux = _rd_loss(opt.model, Latents(yt, zt), torch.tensor(image), 0.01,
                         temperature, "sga", noise)
    gy, gz = torch.autograd.grad(loss, (yt, zt))
    assert_rel(loss.detach(), ref)
    assert_rel(aux["mse"].detach(), ref_aux["mse"])
    assert_rel(aux["bpp"].detach(), ref_aux["bpp"])
    assert_rel(gy, ref_grads.y, GRAD_RTOL)
    assert_rel(gz, ref_grads.z, GRAD_RTOL)


def test_sga_trajectory_matches_jax(models, image):
    jopt, opt = models
    steps = 5
    ref = jopt.optimize(image, 0.01, method=JAX_SGA.replace(iterations=steps), seed=0)
    out = opt.optimize(image, 0.01, method=SGA.replace(iterations=steps), seed=0,
                       noise_fn=jax_gumbel_fn(0, steps))
    assert set(out) == set(ref)
    assert out["losses"].shape == (steps,)
    assert_rel(out["losses"], ref["losses"])
    np.testing.assert_array_equal(out["y"], ref["y"])
    np.testing.assert_array_equal(out["z"], ref["z"])
    for k in METRIC_KEYS:
        assert_rel(out[k], ref[k])
    assert opt.last_timing["steps"] == steps and opt.last_timing["loop_ms"] > 0


def test_eval_amortized_and_rounded_match_jax(models, image):
    jopt, opt = models
    ref = jopt.eval_amortized(image)
    out = opt.eval_amortized(image)
    assert set(out) == set(ref)
    for k in METRIC_KEYS:
        assert_rel(out[k], ref[k])
    y0, z0 = (np.asarray(a) for a in jopt.amortized_init(image))
    ref = jopt.eval_rounded(image, y0, z0)
    out = opt.eval_rounded(image, y0, z0)
    for k in METRIC_KEYS:
        assert_rel(out[k], ref[k])


def test_sga_noise_comes_from_the_seed(models, image):
    _, opt = models
    spec = SGA.replace(iterations=3)
    a = opt.optimize(image, 0.01, method=spec, seed=3)
    b = opt.optimize(image, 0.01, method=spec, seed=3)
    c = opt.optimize(image, 0.01, method=spec, seed=4)
    np.testing.assert_array_equal(a["losses"], b["losses"])
    assert not np.array_equal(a["losses"], c["losses"])


def test_unported_methods_raise():
    """Every method of nic_tpu's engine is ported; a name it does not know
    (the bits-back scripts run another engine) raises, as in nic_tpu."""
    for name in ("sga", "map", "ste", "unoise", "danneal"):
        assert get_method(name).name == name
    for name in ("bb_sga", "nope"):
        with pytest.raises(ValueError, match="unknown method"):
            get_method(name)


def test_sga_beats_amortized_on_photo_crop():
    """SGA on the committed nf=192 checkpoint lowers the rounded RD objective
    below the amortized one (as tests/test_infer.py asserts for nic_tpu)."""
    _, model = load_model(os.path.join(ROOT, "checkpoints_synth3"),
                          "mbt2018-num_filters=192-lmbda=0.01", 192, "cpu")
    opt = LatentOptimizer(model, "cpu")
    x = np.load(os.path.join(ROOT, "data_real", "eval_photos.npy"))
    x = x[:2, 100:164, 200:264].astype(np.float32) / 255.0
    base = opt.eval_amortized(x)
    res = opt.optimize(x, 0.01, method=SGA.replace(iterations=100), seed=0)
    rd_base = 0.01 * base["mse"].mean() + base["est_bpp"].mean()
    rd_opt = 0.01 * res["mse"].mean() + res["est_bpp"].mean()
    assert np.all(np.isfinite(res["losses"]))
    assert rd_opt < rd_base, f"SGA ({rd_opt}) should beat amortized ({rd_base})"
