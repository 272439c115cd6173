"""The port's ops (nic_tpu_torch.ops) against nic_tpu's, on the CPU.

Inputs are made with numpy from a seed and fed to both. Tolerances: 1e-5
relative for float32 values and 1e-4 for gradients, each elementwise with
an absolute floor of the same fraction of the largest reference magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nic_tpu.infer.adam import adam_init as jax_adam_init
from nic_tpu.infer.adam import adam_update as jax_adam_update
from nic_tpu.ops import bounds as jax_bounds
from nic_tpu.ops import quantize as jax_quantize
from nic_tpu.ops import schedules as jax_schedules
from nic_tpu.ops import stats as jax_stats
from nic_tpu_torch.infer.adam import adam_init, adam_update
from nic_tpu_torch.ops import bounds, quantize, schedules, stats

torch.set_num_threads(1)

VALUE_RTOL = 1e-5
GRAD_RTOL = 1e-4


def assert_rel(actual, expected, rtol):
    actual = np.asarray(actual, np.float64)
    expected = np.asarray(expected, np.float64)
    floor = rtol * max(float(np.abs(expected).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=floor)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


@pytest.mark.parametrize("mode", ["identity_if_towards", "identity", "disconnected"])
@pytest.mark.parametrize("which", ["lower", "upper"])
def test_bounds_values_and_gradients(mode, which):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (64,)).astype(np.float32)
    g = rng.normal(0, 1, (64,)).astype(np.float32)
    bound = 0.3
    jax_fn = getattr(jax_bounds, f"{which}_bound")
    fn = getattr(bounds, f"{which}_bound")
    ref, vjp = jax.vjp(lambda v: jax_fn(v, bound, gradient=mode), jnp.asarray(x))
    (ref_grad,) = vjp(jnp.asarray(g))
    xt = _t(x, grad=True)
    out = fn(xt, bound, gradient=mode)
    (grad,) = torch.autograd.grad(out, xt, _t(g))
    assert_rel(out.detach(), ref, VALUE_RTOL)
    assert_rel(grad, ref_grad, GRAD_RTOL)


def test_bounds_reject_unknown_mode():
    with pytest.raises(ValueError):
        bounds.lower_bound(torch.zeros(2), 0.0, gradient="nope")


def test_stats_match():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 3, (256,)).astype(np.float32)
    mu = rng.normal(0, 1, (256,)).astype(np.float32)
    sigma = rng.uniform(0.11, 5.0, (256,)).astype(np.float32)
    assert_rel(stats.gaussian_standardized_cumulative(_t(x)),
               jax_stats.gaussian_standardized_cumulative(jnp.asarray(x)), VALUE_RTOL)
    assert_rel(
        stats.box_convolved_gaussian_likelihood(_t(x), _t(mu), _t(sigma)),
        jax_stats.box_convolved_gaussian_likelihood(
            jnp.asarray(x), jnp.asarray(mu), jnp.asarray(sigma)),
        VALUE_RTOL,
    )


@pytest.mark.parametrize("t", [0, 1, 350, 699, 700, 701, 1200, 1999, 30000])
def test_annealed_temperature_exp0(t):
    kw = dict(r=1e-3, ub=0.5, scheme="exp0", t0=700)
    ref = float(jax_schedules.annealed_temperature(t, **kw))
    assert_rel(schedules.annealed_temperature(t, **kw), ref, VALUE_RTOL)


def test_annealed_temperature_other_schemes_not_ported():
    """Every scheme of nic_tpu is ported; an unknown one raises, as there."""
    with pytest.raises(NotImplementedError, match="Unknown annealing scheme"):
        schedules.annealed_temperature(3, r=1e-3, ub=0.5, scheme="cosine")


@pytest.mark.parametrize("temperature", [0.5, 0.05])
def test_sga_logits(temperature):
    v = np.random.default_rng(2).normal(0, 3, (4, 5, 6)).astype(np.float32)
    ref = jax_quantize.sga_logits(jnp.asarray(v), temperature)
    out = quantize.sga_logits(_t(v), temperature)
    for a, b in zip(out, ref):
        assert_rel(a, b, VALUE_RTOL)


@pytest.mark.parametrize("temperature", [0.5, 0.1])
def test_sga_relax_with_jax_gumbel_draws(temperature):
    v = np.random.default_rng(3).normal(0, 3, (2, 3, 4, 5)).astype(np.float32)
    w = np.random.default_rng(4).normal(0, 1, v.shape).astype(np.float32)
    key = jax.random.PRNGKey(11)
    # sga_relax draws jax.random.gumbel(key, v.shape + (2,)).
    draws = np.asarray(jax.random.gumbel(key, v.shape + (2,)))

    def jax_obj(vv):
        out = jax_quantize.sga_relax(vv, temperature, key)
        return jnp.sum(out * w), out

    (_, ref), ref_grad = jax.value_and_grad(jax_obj, has_aux=True)(jnp.asarray(v))
    vt = _t(v, grad=True)
    out = quantize.sga_relax(vt, temperature, gumbel=_t(draws))
    (grad,) = torch.autograd.grad(torch.sum(out * _t(w)), vt)
    assert_rel(out.detach(), ref, VALUE_RTOL)
    assert_rel(grad, ref_grad, GRAD_RTOL)


def test_sga_relax_draws_from_generator():
    v = torch.linspace(-2.0, 2.0, 1000)
    a = quantize.sga_relax(v, 0.5, generator=torch.Generator().manual_seed(5))
    b = quantize.sga_relax(v, 0.5, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    # Relaxed rounding stays between floor and ceil.
    assert torch.all(a >= torch.floor(v)) and torch.all(a <= torch.ceil(v))
    draws = quantize.draw_gumbel((200000,), torch.Generator().manual_seed(0), "cpu")
    # Gumbel(0, 1): mean is the Euler-Mascheroni constant, variance pi^2/6.
    assert abs(draws.mean().item() - 0.5772157) < 0.01
    assert abs(draws.var().item() - np.pi ** 2 / 6) < 0.03
    with pytest.raises(ValueError):
        quantize.sga_relax(v, 0.5)


def test_adam_matches_jax():
    rng = np.random.default_rng(6)
    p0 = rng.normal(size=(2, 3, 4)).astype(np.float32)
    grads = [rng.normal(size=p0.shape).astype(np.float32) for _ in range(6)]
    p_jax = {"a": jnp.asarray(p0)}
    state_jax = jax_adam_init(p_jax)
    p = torch.tensor(p0)
    state = adam_init((p,))
    for g in grads:
        p_jax, state_jax = jax_adam_update(p_jax, {"a": jnp.asarray(g)}, state_jax, 0.005)
        state = adam_update((p,), (torch.tensor(g),), state, 0.005)
    assert state.t == int(state_jax.t) == len(grads)
    assert_rel(p, p_jax["a"], VALUE_RTOL)
    assert_rel(state.m[0], state_jax.m["a"], VALUE_RTOL)
    assert_rel(state.v[0], state_jax.v["a"], VALUE_RTOL)
