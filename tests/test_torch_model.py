"""MBT2018 in the port against nic_tpu's, on the CPU: parameters mapped by
``params_from_jax``, every sub-pass of a JAX-initialized nf=16 model, and the
committed nf=192 checkpoint on a 64x64 crop of the real photos.

Tolerance: float32 values 1e-5 relative, elementwise with an absolute floor
of the same fraction of the largest reference magnitude.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from nic_tpu.models.mbt2018 import MeanScaleHyperprior as JaxMBT
from nic_tpu.models.mbt2018 import eval_bpp as jax_eval_bpp
from nic_tpu.train.checkpoint import load_params_npz as jax_load_params_npz
from nic_tpu_torch.checkpoint import latest_npz, load_model, load_params_npz, params_from_jax
from nic_tpu_torch.models.mbt2018 import LN2, MeanScaleHyperprior

torch.set_num_threads(1)

VALUE_RTOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT_DIR = os.path.join(ROOT, "checkpoints_synth3")
RUN = "mbt2018-num_filters=192-lmbda=0.01"
PHOTOS = os.path.join(ROOT, "data_real", "eval_photos.npy")
OUTPUT_KEYS = ("y", "z", "z_tilde", "z_likelihoods", "mu", "sigma", "y_tilde",
               "y_likelihoods", "x_tilde")


def assert_rel(actual, expected, rtol=VALUE_RTOL):
    actual = np.asarray(actual, np.float64)
    expected = np.asarray(expected, np.float64)
    floor = rtol * max(float(np.abs(expected).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=floor)


def eval_bpp(outputs, num_pixels):
    """Per-image estimated (total, y, z) bpp of the port's outputs."""
    y = -torch.sum(torch.log(outputs["y_likelihoods"]), dim=(1, 2, 3)) / (LN2 * num_pixels)
    z = -torch.sum(torch.log(outputs["z_likelihoods"]), dim=(1, 2, 3)) / (LN2 * num_pixels)
    return y + z, y, z


def _flat(params):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(params, sep="/").items()}


def _port_model(flat):
    nf = flat["analysis/layer_0/kernel"].shape[-1]
    model = MeanScaleHyperprior(nf)
    model.load_state_dict(params_from_jax(flat))
    return model.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def small():
    jmodel = JaxMBT(num_filters=16)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                            training=True, rng=jax.random.PRNGKey(1))
    params = variables["params"]
    return jmodel, params, _port_model(_flat(params))


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(7).random((2, 48, 80, 3)).astype(np.float32)


def test_sub_passes_match(small, image):
    jmodel, params, model = small

    def japply(method, *args):
        return jmodel.apply({"params": params}, *args, method=getattr(jmodel, method))

    t = torch.tensor
    y_ref = japply("analyze", jnp.asarray(image))
    y = model.analyze(t(image))
    assert tuple(y.shape) == y_ref.shape == (2, 3, 5, 16)
    assert_rel(y, y_ref)
    # Feed both the same y from here on, so each sub-pass is held alone.
    y_np = np.asarray(y_ref)
    z_ref = japply("hyper_analyze", jnp.asarray(y_np))
    assert_rel(model.hyper_analyze(t(y_np)), z_ref)
    z_np = np.asarray(z_ref)
    assert_rel(model.quantize_z(t(z_np)), japply("quantize_z", jnp.asarray(z_np)))
    assert_rel(model.entropy_bottleneck.medians, japply("medians"))
    zt = np.asarray(japply("quantize_z", jnp.asarray(z_np)))
    mu_ref, sigma_ref = japply("hyper_synthesize", jnp.asarray(zt), (3, 5))
    mu, sigma = model.hyper_synthesize(t(zt), (3, 5))
    assert tuple(mu.shape) == (2, 3, 5, 16)
    assert_rel(mu, mu_ref)
    assert_rel(sigma, sigma_ref)
    assert_rel(model.z_likelihood(t(zt)), japply("z_likelihood", jnp.asarray(zt)))
    yt = np.round(y_np)
    assert_rel(
        model.y_likelihood(t(yt), t(np.asarray(mu_ref)), t(np.asarray(sigma_ref))),
        japply("y_likelihood", jnp.asarray(yt), mu_ref, sigma_ref),
    )
    x_ref = japply("synthesize", jnp.asarray(yt), (48, 80))
    assert_rel(model.synthesize(t(yt), (48, 80)), x_ref)


def test_eval_forward_matches(small, image):
    jmodel, params, model = small
    ref = jmodel.apply({"params": params}, jnp.asarray(image), training=False)
    out = model(torch.tensor(image))
    for k in OUTPUT_KEYS:
        assert tuple(out[k].shape) == ref[k].shape, k
        assert_rel(out[k], ref[k])
    for ours, theirs in zip(eval_bpp(out, 48 * 80), jax_eval_bpp(ref, 48 * 80)):
        assert_rel(ours, theirs)


def test_params_from_jax_rejects_bad_keys(small):
    _, params, _ = small
    flat = _flat(params)
    missing = dict(flat)
    del missing["synthesis/igdn_1/gamma"]
    with pytest.raises(KeyError, match="synthesis.igdn_1.gamma"):
        params_from_jax(missing)
    extra = dict(flat, **{"synthesis/layer_9/kernel": flat["synthesis/layer_0/kernel"]})
    with pytest.raises(KeyError, match="layer_9"):
        params_from_jax(extra)
    extra_leaf = dict(flat, **{"analysis/gdn_0/alpha": flat["analysis/gdn_0/beta"]})
    with pytest.raises(KeyError, match="alpha"):
        params_from_jax(extra_leaf)
    misshaped = dict(flat, **{"analysis/gdn_0/beta": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="gdn_0"):
        params_from_jax(misshaped)


@pytest.fixture(scope="module")
def committed():
    path = latest_npz(os.path.join(CKPT_DIR, RUN))
    _, flat = load_params_npz(path)
    _, jparams = jax_load_params_npz(path)
    return flat, jparams


def test_committed_checkpoint_loads(committed):
    flat, _ = committed
    assert len(flat) == 51
    state = params_from_jax(flat)  # raises on any missing/extra/mis-shaped key
    assert set(state) == set(MeanScaleHyperprior(192).state_dict())
    step, model = load_model(CKPT_DIR, RUN, 192, "cpu")
    assert step == 320000
    assert not any(p.requires_grad for p in model.parameters())
    with pytest.raises(ValueError, match="num_filters"):
        load_model(CKPT_DIR, RUN, 128, "cpu")
    with pytest.raises(FileNotFoundError):
        load_model(CKPT_DIR, "mbt2018-no-such-run", 192, "cpu")


def test_committed_checkpoint_forward_on_photo_crop(committed):
    flat, jparams = committed
    x = (np.load(PHOTOS)[:1, 100:164, 200:264].astype(np.float32) / 255.0)
    ref = JaxMBT(num_filters=192).apply({"params": jparams}, jnp.asarray(x),
                                        training=False)
    out = _port_model(flat)(torch.tensor(x))
    for k in OUTPUT_KEYS:
        assert tuple(out[k].shape) == ref[k].shape, k
        assert_rel(out[k], ref[k])
    for ours, theirs in zip(eval_bpp(out, 64 * 64), jax_eval_bpp(ref, 64 * 64)):
        assert_rel(ours, theirs)
