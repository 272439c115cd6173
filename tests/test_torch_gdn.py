"""K1, the fused GDN: the port's plain version, gradient and dispatch
against nic_tpu's GDN (plain XLA, and the Pallas kernel in interpret mode as
tests/test_pallas_gdn.py runs it), on the CPU. The CUDA kernel itself is
held against its plain version on the card by tests/test_torch_cuda.py.

Tolerances: float32 values 1e-5 relative, gradients 1e-4, bfloat16 values
2e-2 (a few bf16 ulps); each elementwise with an absolute floor of the same
fraction of the largest reference magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nic_tpu.ops.gdn import gdn as jax_gdn
from nic_tpu.ops.pallas_gdn import gdn_pallas
from nic_tpu_torch.ops import gdn_cuda
from nic_tpu_torch.ops.gdn import gdn, gdn_reference
from tc_emulation import committed_gs_layers, gdn_emulated, split_tf32, tf32_rna

torch.set_num_threads(1)

VALUE_RTOL = 1e-5
GRAD_RTOL = 1e-4
BF16_RTOL = 2e-2
# The kernel against its plain version on the card (chip_smoke.py K1_RTOL,
# tests/test_torch_cuda.py), max-norm relative.
CARD_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def assert_rel(actual, expected, rtol):
    actual = np.asarray(actual, np.float64)
    expected = np.asarray(expected, np.float64)
    floor = rtol * max(float(np.abs(expected).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=floor)


def make_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.normal(0, 2, shape).astype(np.float32)
    gamma = (0.1 * np.eye(c) + 0.01 * rng.random((c, c))).astype(np.float32)
    beta = (1.0 + 0.1 * rng.random(c)).astype(np.float32)
    return x, beta, gamma


SHAPES = [(2, 8, 8, 16), (37, 16)]  # NHWC, and an odd row count


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("inverse", [False, True])
def test_reference_matches_jax_f32(shape, inverse):
    x, beta, gamma = make_inputs(shape)
    out = gdn_reference(torch.tensor(x), torch.tensor(beta), torch.tensor(gamma), inverse)
    ref_xla = jax_gdn(jnp.asarray(x), jnp.asarray(beta), jnp.asarray(gamma), inverse=inverse)
    ref_pallas = gdn_pallas(jnp.asarray(x), jnp.asarray(beta), jnp.asarray(gamma),
                            inverse=inverse, interpret=True)
    assert out.dtype == torch.float32 and out.shape == shape
    assert_rel(out, ref_xla, VALUE_RTOL)
    assert_rel(out, ref_pallas, VALUE_RTOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("inverse", [False, True])
def test_reference_matches_jax_bf16(shape, inverse):
    x, beta, gamma = make_inputs(shape, seed=1)
    xb = torch.tensor(x).to(torch.bfloat16)
    out = gdn_reference(xb, torch.tensor(beta), torch.tensor(gamma), inverse)
    assert out.dtype == torch.bfloat16
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    ref_xla = jax_gdn(xj, jnp.asarray(beta), jnp.asarray(gamma).astype(jnp.bfloat16),
                      inverse=inverse)
    ref_pallas = gdn_pallas(xj, jnp.asarray(beta), jnp.asarray(gamma),
                            inverse=inverse, interpret=True)
    assert_rel(out.float(), np.asarray(ref_xla, np.float32), BF16_RTOL)
    assert_rel(out.float(), np.asarray(ref_pallas, np.float32), BF16_RTOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("inverse", [False, True])
def test_gradients_match_jax(shape, inverse):
    """dx, dbeta, dgamma: autograd of the plain version and the kernel's
    analytic backward, against JAX's grad of the Pallas GDN (custom VJP)."""
    x, beta, gamma = make_inputs(shape, seed=2)
    w = np.random.default_rng(3).normal(0, 1, shape).astype(np.float32)

    def f(xx, bb, gg):
        return jnp.sum(gdn_pallas(xx, bb, gg, inverse=inverse, interpret=True) * w)

    refs = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(beta),
                                           jnp.asarray(gamma))
    refs_xla = jax.grad(
        lambda xx, bb, gg: jnp.sum(jax_gdn(xx, bb, gg, inverse=inverse) * w),
        argnums=(0, 1, 2),
    )(jnp.asarray(x), jnp.asarray(beta), jnp.asarray(gamma))

    xt, bt, gt = (torch.tensor(a, requires_grad=True) for a in (x, beta, gamma))
    out = gdn_reference(xt, bt, gt, inverse)
    grads = torch.autograd.grad(torch.sum(out * torch.tensor(w)), (xt, bt, gt))
    c = shape[-1]
    dx, dgamma, dbeta = gdn_cuda.gdn_backward(
        torch.tensor(x).reshape(-1, c), torch.tensor(gamma), torch.tensor(beta),
        torch.tensor(w).reshape(-1, c), inverse,
    )
    for ours, ref, ref_xla in zip(grads, refs, refs_xla):
        assert_rel(ours, ref, GRAD_RTOL)
        assert_rel(ours, ref_xla, GRAD_RTOL)
    assert_rel(dx.reshape(shape), refs[0], GRAD_RTOL)
    assert_rel(dbeta, refs[1], GRAD_RTOL)
    assert_rel(dgamma, refs[2], GRAD_RTOL)


def test_backward_skips_unneeded_gradients():
    x, beta, gamma = make_inputs((5, 8))
    dx, dgamma, dbeta = gdn_cuda.gdn_backward(
        torch.tensor(x), torch.tensor(gamma), torch.tensor(beta), torch.ones(5, 8),
        False, need_gamma=False, need_beta=False,
    )
    assert dx.shape == (5, 8) and dgamma is None and dbeta is None


def test_dispatch_on_cpu_takes_plain_version():
    x, beta, gamma = (torch.tensor(a) for a in make_inputs((2, 3, 5, 8)))
    before = gdn_cuda.launches
    for inverse in (False, True):
        torch.testing.assert_close(gdn(x, beta, gamma, inverse),
                                   gdn_reference(x, beta, gamma, inverse),
                                   rtol=0, atol=0)
    assert gdn_cuda.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    x, beta, gamma = (torch.tensor(a) for a in make_inputs((9, 8)))
    with pytest.raises(ValueError, match="CUDA"):
        gdn_cuda.gdn_forward_kernel(x, gamma, beta, False)


@pytest.mark.parametrize("inverse", [False, True])
def test_reference_bf16_squares_x_in_bf16_as_the_pallas_kernel(inverse):
    """gdn_reference's bfloat16 branch rounds x^2 to bfloat16 before the
    fp32 product, as _gdn_kernel's jnp.square does (and the CUDA kernel)."""
    x, beta, gamma = make_inputs((64, 16), seed=4)
    xb = torch.tensor(x).bfloat16()
    out = gdn_reference(xb, torch.tensor(beta), torch.tensor(gamma), inverse)
    xsq = (xb * xb).float()
    assert not torch.equal(xsq, xb.float() ** 2)  # the rounding is visible here
    norm = xsq @ torch.tensor(gamma).bfloat16().float() + torch.tensor(beta)
    scale = torch.sqrt(norm) if inverse else torch.rsqrt(norm)
    assert torch.equal(out, (xb.float() * scale).bfloat16())
    ref = gdn_pallas(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(beta),
                     jnp.asarray(gamma), inverse=inverse, interpret=True)
    assert_rel(out.float(), np.asarray(ref, np.float32), BF16_RTOL)


@pytest.mark.parametrize("round_hi,bound", [(True, 2.0 ** -22), (False, 2.0 ** -21)],
                         ids=["rna", "truncated-hi"])
def test_tf32_emulation_rounds_as_cvt_rna(round_hi, bound):
    """tc_emulation's TF32 rounding: 10 mantissa bits, ties away from zero;
    hi + lo within 2^-22 of v with hi rounded (K2), 2^-21 with hi truncated
    (K1)."""
    one_ulp = 2.0 ** -10
    v = torch.tensor([1.0 + one_ulp / 2, -(1.0 + one_ulp / 2), 1.0 + one_ulp / 4, 3.0])
    assert tf32_rna(v).tolist() == [1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 3.0]
    x = torch.from_numpy(np.random.default_rng(6).normal(0, 3, 4096).astype(np.float32))
    hi, lo = split_tf32(x, round_hi)
    for part in (hi, lo):
        assert not torch.any(part.view(torch.int32) & 0x1FFF)
    assert float(((hi + lo - x).abs() / x.abs()).max()) <= bound


@pytest.fixture(scope="module")
def gs_layers():
    return committed_gs_layers()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("inverse", [True, False], ids=["igdn", "gdn"])
def test_kernel_rounding_within_card_tolerance_on_committed_gs(gs_layers, dtype, inverse):
    """The kernel's operand rounding (bf16: x^2 and gamma in bf16; fp32:
    3xTF32), emulated in plain torch at full width (C = 192) on the IGDN
    inputs of the committed checkpoint's three g_s layers, stays within the
    on-card tolerance of the plain version on the same inputs."""
    for layer in gs_layers:
        z = layer["z"].to(dtype)
        got = gdn_emulated(z, layer["beta"], layer["gamma"], inverse)
        ref = gdn_reference(z.float(), layer["beta"], layer["gamma"].to(dtype).float(), inverse)
        err = float((got.float() - ref).abs().max() / ref.abs().max())
        assert err <= CARD_RTOL[dtype], (tuple(z.shape), err)
