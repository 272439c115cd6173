"""SignalConv's up-sampling variants against nic_tpu's, on the CPU: the
"phases" and "subpixel" forms of the stride-2 up-conv, the 2x2-block-space
output and ``MeanScaleHyperprior.synthesize_blocks`` (nic_tpu's
models/layers.py and tests/test_models.py's TestSubpixelEquivalence).

The rearranged kernels are equal bit for bit (they only move weights).
Tolerances: float32 values 1e-5 and gradients 1e-4 relative, elementwise
with an absolute floor of the same fraction of the largest reference
magnitude (tests/test_torch_layers.py's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from nic_tpu.models import layers as jax_layers
from nic_tpu.models.mbt2018 import MeanScaleHyperprior as JaxMBT
from nic_tpu_torch.checkpoint import params_from_jax
from nic_tpu_torch.models import layers
from nic_tpu_torch.models.layers import SignalConv
from nic_tpu_torch.models.mbt2018 import MeanScaleHyperprior

torch.set_num_threads(1)

DN = ("NHWC", "HWIO", "NHWC")
VALUE_RTOL = 1e-5
GRAD_RTOL = 1e-4


def assert_rel(actual, expected, rtol):
    actual = np.asarray(actual, np.float64)
    expected = np.asarray(expected, np.float64)
    floor = rtol * max(float(np.abs(expected).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=floor)


def _pair(k, ci, co, h, w, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, h, w, ci)).astype(np.float32)
    kern = rng.normal(size=(k, k, ci, co)).astype(np.float32)
    return x, kern


@pytest.mark.parametrize("k,ci,co,h,w", [(5, 4, 6, 9, 7), (3, 3, 5, 6, 6), (4, 3, 5, 5, 6)])
def test_subpixel_matches_nic_tpu(k, ci, co, h, w):
    """The 3x3 kernel with 4 Co outputs equals nic_tpu's, and its conv
    followed by depth-to-space is the SAME transposed conv."""
    x, kern = _pair(k, ci, co, h, w, 0)
    k4 = layers.subpixel_kernel_up2(torch.from_numpy(kern))
    np.testing.assert_array_equal(k4.numpy(), np.asarray(
        jax_layers._subpixel_kernel_up2(jnp.asarray(kern))))
    ref = jax.lax.conv_transpose(jnp.asarray(x), jnp.asarray(kern), (2, 2), "SAME",
                                 dimension_numbers=DN)
    got = layers.depth_to_space2(layers._subpixel_conv(torch.from_numpy(x),
                                                       torch.from_numpy(kern)), co)
    assert_rel(got, ref, VALUE_RTOL)


@pytest.mark.parametrize("ci,co,h,w", [(4, 6, 9, 7), (3, 5, 6, 6)])
def test_phases_matches_nic_tpu(ci, co, h, w):
    """The four parity kernels and pads equal nic_tpu's, and the four dense
    convs interleaved are the SAME transposed conv."""
    x, kern = _pair(5, ci, co, h, w, 1)
    mine = layers.phase_kernels_up2(torch.from_numpy(kern))
    theirs = jax_layers._phase_kernels_up2(jnp.asarray(kern))
    for (r, t, k, pads), (jr, jt, jk, jpads) in zip(mine, theirs):
        assert (r, t, pads) == (jr, jt, jpads)
        np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    ref = jax_layers._conv_transpose_phases_up2(jnp.asarray(x), jnp.asarray(kern))
    got = layers.conv_transpose_phases_up2(torch.from_numpy(x), torch.from_numpy(kern))
    assert_rel(got, ref, VALUE_RTOL)
    assert_rel(got, jax.lax.conv_transpose(jnp.asarray(x), jnp.asarray(kern), (2, 2), "SAME",
                                           dimension_numbers=DN), VALUE_RTOL)


@pytest.mark.parametrize("impl,block_space", [("phases", False), ("subpixel", False),
                                              ("transpose", True)])
@pytest.mark.parametrize("h,w", [(6, 8), (5, 7)])
def test_signal_conv_variant_matches_flax(impl, block_space, h, w):
    """nic_tpu's SignalConv(upsample_impl=...) and its block_space_output,
    forward and input gradient, with a bias."""
    cin, cout = 6, 10
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, h, w, cin)).astype(np.float32)
    layer = jax_layers.SignalConv(cout, (5, 5), strides_up=2, upsample_impl=impl)
    params = dict(layer.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    params["bias"] = jnp.asarray(rng.normal(0, 0.1, (cout,)).astype(np.float32))
    shape = (2, h, w, 4 * cout) if block_space else (2, 2 * h, 2 * w, cout)
    g = rng.normal(0, 1, shape).astype(np.float32)
    ref, vjp = jax.vjp(
        lambda a: layer.apply({"params": params}, a, block_space_output=block_space),
        jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(g))
    conv = SignalConv(cin, cout, 5, strides_up=2, upsample_impl=impl)
    with torch.no_grad():
        conv.weight.copy_(conv.weight_from_hwio(np.asarray(params["kernel"])))
        conv.bias.copy_(torch.from_numpy(np.asarray(params["bias"])))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = conv(xt, block_space_output=block_space)
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    assert out.shape == ref.shape
    assert_rel(out.detach(), ref, VALUE_RTOL)
    assert_rel(dx, ref_dx, GRAD_RTOL)


@pytest.fixture(scope="module")
def nf8():
    params = JaxMBT(num_filters=8).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), training=True,
        rng=jax.random.PRNGKey(1))["params"]
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}
    x = np.random.default_rng(2).random((1, 64, 64, 3), np.float32)
    return params, params_from_jax(flat), x


@pytest.mark.parametrize("impl", ["phases", "subpixel"])
def test_model_upsample_impl_matches_nic_tpu(nf8, impl):
    """The whole eval forward with every up-conv in the variant form, against
    nic_tpu's same model and the port's default."""
    params, state, x = nf8
    ref = JaxMBT(num_filters=8, upsample_impl=impl).apply(
        {"params": params}, jnp.asarray(x), training=False)
    model = MeanScaleHyperprior(8, upsample_impl=impl)
    model.load_state_dict(state)
    default = model.clone(upsample_impl="transpose")
    with torch.no_grad():
        out = model(torch.from_numpy(x))
        out0 = default(torch.from_numpy(x))
    for k in ("x_tilde", "mu", "sigma"):
        assert_rel(out[k], ref[k], VALUE_RTOL)
        assert_rel(out[k], out0[k], VALUE_RTOL)


def test_synthesize_blocks_matches_nic_tpu(nf8):
    """The reconstruction in 2x2-block space: nic_tpu's, and the port's own
    pixels reordered."""
    params, state, _ = nf8
    y = np.random.default_rng(3).normal(0, 2, (2, 4, 5, 8)).astype(np.float32)
    jm = JaxMBT(num_filters=8)
    ref = jm.apply({"params": params}, jnp.asarray(y), (31, 40), method=jm.synthesize_blocks)
    model = MeanScaleHyperprior(8)
    model.load_state_dict(state)
    with torch.no_grad():
        got = model.synthesize_blocks(torch.from_numpy(y), (31, 40))
        pixels = model.synthesize(torch.from_numpy(y))
    assert got.shape == ref.shape == (2, 31, 40, 12)
    assert_rel(got, ref, VALUE_RTOL)
    n, h, w, _ = pixels.shape
    blocks = pixels.reshape(n, h // 2, 2, w // 2, 2, 3).permute(0, 1, 3, 2, 4, 5)
    assert_rel(got, blocks.reshape(n, h // 2, w // 2, 12)[:, :31, :40], VALUE_RTOL)
