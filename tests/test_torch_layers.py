"""The port's SignalConv and GDN layers against nic_tpu's flax layers with
the same parameters, on the CPU.

The padding is the trap: XLA's SAME pads a stride-2 down conv 1/2 on even
sizes and 2/2 on odd ones, and lax.conv_transpose takes an un-flipped HWIO
kernel (5x5 and 3x3); both are checked at even and odd H and W. Tolerances: float32
values 1e-5 relative, gradients 1e-4, each elementwise with an absolute
floor of the same fraction of the largest reference magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nic_tpu.models.layers import GDN as JaxGDN
from nic_tpu.models.layers import SignalConv as JaxSignalConv
from nic_tpu_torch.models.layers import GDN, SignalConv

torch.set_num_threads(1)

VALUE_RTOL = 1e-5
GRAD_RTOL = 1e-4


def assert_rel(actual, expected, rtol):
    actual = np.asarray(actual, np.float64)
    expected = np.asarray(expected, np.float64)
    floor = rtol * max(float(np.abs(expected).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=floor)


CASES = [
    # (kernel, strides_down, strides_up, H, W)
    (5, 2, 1, 8, 8),
    (5, 2, 1, 7, 9),
    (5, 2, 1, 6, 5),
    (3, 1, 1, 6, 8),
    (3, 1, 1, 5, 7),
    (5, 1, 2, 6, 8),
    (5, 1, 2, 5, 7),
    (3, 1, 2, 6, 8),
    (3, 1, 2, 5, 7),
]


@pytest.mark.parametrize("kernel,down,up,h,w", CASES)
def test_signal_conv_matches_flax(kernel, down, up, h, w):
    cin, cout = 6, 10
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, h, w, cin)).astype(np.float32)
    layer = JaxSignalConv(cout, (kernel, kernel), strides_down=down, strides_up=up)
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    bias = rng.normal(0, 0.1, (cout,)).astype(np.float32)
    params = {"kernel": params["kernel"], "bias": jnp.asarray(bias)}
    g = rng.normal(0, 1, (2, h * up, w * up, cout) if up > 1 else
                   (2, -(-h // down), -(-w // down), cout)).astype(np.float32)

    def f(xx):
        out = layer.apply({"params": params}, xx)
        return jnp.sum(out * g), out

    (_, ref), ref_dx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))

    conv = SignalConv(cin, cout, kernel, strides_down=down, strides_up=up)
    with torch.no_grad():
        conv.weight.copy_(conv.weight_from_hwio(np.asarray(params["kernel"])))
        conv.bias.copy_(torch.tensor(bias))
    xt = torch.tensor(x, requires_grad=True)
    out = conv(xt)
    (dx,) = torch.autograd.grad(torch.sum(out * torch.tensor(g)), xt)
    assert out.shape == ref.shape
    assert_rel(out.detach(), ref, VALUE_RTOL)
    assert_rel(dx, ref_dx, GRAD_RTOL)


def test_signal_conv_without_bias_and_bad_configs():
    conv = SignalConv(4, 5, 5, strides_down=2, use_bias=False)
    assert conv.bias is None
    assert conv(torch.zeros(1, 8, 8, 4)).shape == (1, 4, 4, 5)
    with pytest.raises(ValueError):
        SignalConv(4, 5, 5, strides_down=2, strides_up=2)
    # The up-conv forms nic_tpu refuses too.
    with pytest.raises(NotImplementedError):
        SignalConv(4, 5, 3, strides_up=2, upsample_impl="phases")
    with pytest.raises(NotImplementedError):
        SignalConv(4, 5, 7, strides_up=2, upsample_impl="subpixel")


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_layer_reparameterization(inverse):
    """Stored (sqrt-reparameterized) beta/gamma map to the same effective
    values; output and the gradients w.r.t. x, beta and gamma match. Some
    stored values sit below the bounds to exercise lower_bound."""
    c = 12
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 4, 5, c)).astype(np.float32)
    g = rng.normal(0, 1, x.shape).astype(np.float32)
    beta = rng.uniform(-0.2, 1.5, (c,)).astype(np.float32)
    gamma = rng.uniform(-0.05, 0.4, (c, c)).astype(np.float32)
    layer = JaxGDN(inverse=inverse)
    params = {"beta": jnp.asarray(beta), "gamma": jnp.asarray(gamma)}

    def f(xx, p):
        out = layer.apply({"params": p}, xx)
        return jnp.sum(out * g), out

    (_, ref), (ref_dx, ref_dp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), params)

    mod = GDN(c, inverse=inverse)
    with torch.no_grad():
        mod.beta.copy_(torch.tensor(beta))
        mod.gamma.copy_(torch.tensor(gamma))
    xt = torch.tensor(x, requires_grad=True)
    out = mod(xt)
    dx, dbeta, dgamma = torch.autograd.grad(torch.sum(out * torch.tensor(g)),
                                            (xt, mod.beta, mod.gamma))
    assert_rel(out.detach(), ref, VALUE_RTOL)
    assert_rel(dx, ref_dx, GRAD_RTOL)
    assert_rel(dbeta, ref_dp["beta"], GRAD_RTOL)
    assert_rel(dgamma, ref_dp["gamma"], GRAD_RTOL)


def test_gdn_layer_initial_values():
    """Fresh parameters give beta = 1 and gamma = 0.1 I, as in nic_tpu."""
    beta, gamma = GDN(5).effective_params()
    torch.testing.assert_close(beta, torch.ones(5), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(gamma, 0.1 * torch.eye(5), rtol=1e-6, atol=1e-6)
