"""K2, the fused 5x5 up-conv + (I)GDN: the port's plain version (K2's own
formulation, what the CPU runs), its composite and ``fused_synthesis_layer``
against nic_tpu's kernel (the Pallas kernel in interpret mode, as
tests/test_pallas_convt.py runs it) and reference composite, on the CPU.
The CUDA kernel itself is held against its plain version on the card by
tests/test_torch_cuda.py.

Tolerances:
- float32 values 2e-5 relative and absolute, nic_tpu's own bound between
  its kernel and its composite (the same sums in another order);
- bfloat16 values in bf16 ulps of the larger magnitude: the plain version
  against the Pallas kernel 1 ulp (both sum in float32 and round once at
  the store), the composites 2 ulps (both round the conv output, gamma and
  the normalized output to bfloat16, at slightly different places);
- gradients 1e-4 relative with an absolute floor of the same fraction of
  the largest reference magnitude (a backward through three ops in fp32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nic_tpu.ops.pallas_convt import conv_transpose_igdn_up2 as jax_kernel
from nic_tpu.ops.pallas_convt import conv_transpose_igdn_up2_reference as jax_composite
from nic_tpu_torch.ops import convt_igdn
from nic_tpu_torch.tools import exp_fused_convt
from tc_emulation import committed_gs_layers, convt_igdn_emulated

torch.set_num_threads(1)

F32_TOL = 2e-5
GRAD_RTOL = 1e-4
# The kernel against its plain version on the card (chip_smoke.py K2_RTOL,
# tests/test_torch_cuda.py), max-norm relative.
CARD_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def params(rng):
    """tests/test_pallas_convt.py's inputs, as numpy."""
    c, co = 8, 8
    x = rng.standard_normal((2, 12, 16, c)).astype(np.float32)
    w = (rng.standard_normal((5, 5, c, co)) * 0.2).astype(np.float32)
    bias = (rng.standard_normal(co) * 0.1).astype(np.float32)
    beta = rng.uniform(0.5, 1.5, co).astype(np.float32)
    gamma = rng.uniform(0.0, 0.2, (co, co)).astype(np.float32)
    return x, w, bias, beta, gamma


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def bf16_ulps(a, b):
    """Largest |a - b| in bf16 ulps of max(|a|, |b|) (8 significand bits)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), 2.0 ** -100)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    return float(np.max(np.abs(a - b) / ulp))


def assert_rel(actual, expected, rtol):
    actual = np.asarray(actual, np.float64)
    expected = np.asarray(expected, np.float64)
    floor = rtol * max(float(np.abs(expected).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=floor)


def test_phase_weight_mats_shapes(params):
    _, w, *_ = params
    mats = convt_igdn.phase_weight_mats(torch.from_numpy(w))
    taps = [m.shape[0] // w.shape[2] for m in mats]
    # Parities (0,0)/(0,1)/(1,0)/(1,1) have 2x2/2x3/3x2/3x3 live taps.
    assert taps == [4, 6, 6, 9] and sum(taps) == 25
    assert all(m.shape[1] == w.shape[3] for m in mats)


def test_phase_weight_mats_match_nic_tpu(params):
    from nic_tpu.ops.pallas_convt import phase_weight_mats as jax_mats

    _, w, *_ = params
    for got, want in zip(convt_igdn.phase_weight_mats(torch.from_numpy(w)),
                         jax_mats(jnp.asarray(w))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("crop", [(12, 16), (10, 13)], ids=["aligned", "odd"])
@pytest.mark.parametrize("inverse", [True, False], ids=["igdn", "gdn"])
def test_plain_and_composite_match_nic_tpu_float32(params, crop, inverse):
    x, w, bias, beta, gamma = params
    x = x[:, : crop[0], : crop[1]]
    want_kernel = np.asarray(jax_kernel(*_jax(x, w, bias, beta, gamma),
                                        inverse=inverse, row_tile=4, interpret=True))
    want_composite = np.asarray(jax_composite(*_jax(x, w, bias, beta, gamma),
                                              inverse=inverse))
    args = _torch(x, w, bias, beta, gamma)
    plain = convt_igdn.conv_transpose_igdn_up2_plain(*args, inverse=inverse).numpy()
    composite = convt_igdn.conv_transpose_igdn_up2_reference(
        *args, inverse=inverse).numpy()
    dispatched = convt_igdn.conv_transpose_igdn_up2(*args, inverse=inverse).numpy()
    assert plain.shape == want_kernel.shape == (2, 2 * crop[0], 2 * crop[1], 8)
    np.testing.assert_allclose(plain, want_kernel, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(composite, want_composite, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(plain, want_composite, rtol=F32_TOL, atol=F32_TOL)
    # On a CPU tensor the wrapper is the plain version.
    np.testing.assert_array_equal(dispatched, plain)


@pytest.mark.parametrize("inverse", [True, False], ids=["igdn", "gdn"])
def test_bfloat16_within_a_few_ulps_of_nic_tpu(params, inverse):
    x, w, bias, beta, gamma = params
    xb = jnp.asarray(x, jnp.bfloat16)
    rest = _jax(w, bias, beta, gamma)
    want_kernel = np.asarray(jax_kernel(xb, *rest, inverse=inverse, row_tile=4,
                                        interpret=True).astype(jnp.float32))
    want_composite = np.asarray(jax_composite(xb, *rest, inverse=inverse)
                                .astype(jnp.float32))
    xt = torch.from_numpy(x).bfloat16()
    args = _torch(w, bias, beta, gamma)
    plain = convt_igdn.conv_transpose_igdn_up2_plain(xt, *args, inverse=inverse)
    composite = convt_igdn.conv_transpose_igdn_up2_reference(xt, *args, inverse=inverse)
    assert plain.dtype == composite.dtype == torch.bfloat16
    assert bf16_ulps(plain.float().numpy(), want_kernel) <= 1
    assert bf16_ulps(composite.float().numpy(), want_composite) <= 2


@pytest.mark.parametrize("inverse", [True, False], ids=["igdn", "gdn"])
def test_fused_synthesis_layer_gradients_match_jax_vjp(params, inverse):
    """All five cotangents of the port's autograd.Function against jax.vjp of
    nic_tpu's reference composite (nic_tpu's own fused_synthesis_layer calls
    the Pallas kernel without interpret mode, so it cannot run here)."""
    x, w, bias, beta, gamma = params
    x = x[:, :10, :13]
    gy = np.random.default_rng(5).standard_normal((2, 20, 26, 8)).astype(np.float32)
    y_ref, vjp = jax.vjp(
        lambda *a: jax_composite(*a, inverse=inverse), *_jax(x, w, bias, beta, gamma))
    want = vjp(jnp.asarray(gy))
    args = [t.requires_grad_(True) for t in _torch(x, w, bias, beta, gamma)]
    y = convt_igdn.fused_synthesis_layer(*args, inverse=inverse)
    got = torch.autograd.grad(y, args, torch.from_numpy(gy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               rtol=F32_TOL, atol=F32_TOL)
    for name, g, r in zip(("x", "w", "bias", "beta", "gamma"), got, want):
        assert g.shape == r.shape, name
        assert_rel(g.numpy(), np.asarray(r), GRAD_RTOL)


def test_fused_synthesis_layer_only_differentiates_what_is_asked(params):
    x, w, bias, beta, gamma = _torch(*params)
    x.requires_grad_(True)
    y = convt_igdn.fused_synthesis_layer(x, w, bias, beta, gamma)
    (dx,) = torch.autograd.grad(y.sum(), [x])
    assert dx.shape == x.shape and w.grad is None


def test_exp_fused_convt_check_on_the_cpu(capsys):
    errors = exp_fused_convt.main(["check", "--device", "cpu"])
    assert set(errors) == {"float32", "bfloat16"}
    for name, e in errors.items():
        assert e["plain"] == 0.0  # on the CPU the wrapper is the plain version
    assert errors["float32"]["composite"] <= exp_fused_convt.COMPOSITE_RTOL[torch.float32]
    assert "CHECK OK" in capsys.readouterr().out


def test_wrapper_refuses_other_devices(params):
    args = _torch(*params)
    with pytest.raises(ValueError, match="cuda or cpu"):
        convt_igdn.conv_transpose_igdn_up2(args[0].to("meta"), *args[1:])
    with pytest.raises(ValueError, match="CUDA tensors"):
        convt_igdn.convt_igdn_forward_kernel(*args, True)


def unpack_weights(packed, c, co):
    """The four phase_weight_mats [taps * C, Co] back from pack_weights."""
    cpad = -(-c // convt_igdn.K_CHUNK[packed.dtype]) * convt_igdn.K_CHUNK[packed.dtype]
    mats, row = [], 0
    for taps in (4, 6, 6, 9):
        block = packed[row: row + taps * cpad].reshape(taps, cpad, -1)
        mats.append(block[:, :c, :co].reshape(taps * c, co))
        row += taps * cpad
    return mats


@pytest.mark.parametrize("c,co", [(8, 8), (40, 24), (192, 192)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_packed_weights_unpack_to_nic_tpu_phase_weight_mats(c, co, dtype):
    """K2's weight operand, packed and unpacked again, is nic_tpu's
    phase_weight_mats of the same weights (in the route's dtype), and its
    padding is zero."""
    from nic_tpu.ops.pallas_convt import phase_weight_mats as jax_mats

    w = np.random.default_rng(7).standard_normal((5, 5, c, co)).astype(np.float32)
    packed = convt_igdn.pack_weights(torch.from_numpy(w), dtype)
    cpad = -(-c // convt_igdn.K_CHUNK[dtype]) * convt_igdn.K_CHUNK[dtype]
    cop = -(-co // convt_igdn.CO_ALIGN) * convt_igdn.CO_ALIGN
    assert packed.shape == (25 * cpad, cop) and packed.dtype == dtype
    assert packed.is_contiguous()
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    mats = unpack_weights(packed, c, co)
    for got, want in zip(mats, jax_mats(jnp.asarray(w).astype(jdtype))):
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    # Every weight is nonzero, so the packing holds nothing else but zeros.
    assert int(torch.count_nonzero(packed)) == 25 * c * co
    assert sum(int(torch.count_nonzero(m)) for m in mats) == 25 * c * co


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_packed_gamma_is_zero_padded_in_the_route_dtype(dtype):
    gamma = torch.from_numpy(np.random.default_rng(8).uniform(0, 0.1, (24, 24)).astype(np.float32))
    packed = convt_igdn.pack_gamma(gamma, dtype)
    assert packed.shape == (64, 64) and packed.dtype == dtype
    assert torch.equal(packed[:24, :24], gamma.to(dtype))
    assert not packed[24:].any() and not packed[:, 24:].any()


@pytest.fixture(scope="module")
def gs_layers():
    return committed_gs_layers()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("inverse", [True, False], ids=["igdn", "gdn"])
def test_kernel_rounding_within_card_tolerance_on_committed_gs(gs_layers, dtype, inverse):
    """K2's operand rounding (bf16: x, w, z kept in bf16, and z*z and gamma
    for the normalizer; fp32: both GEMMs in 3xTF32), emulated in plain torch at full
    width (C = Co = 192, K up to 9 * 192) on the committed checkpoint's three
    g_s layers, stays within the on-card tolerance of the plain version on
    the same inputs."""
    for layer in gs_layers:
        args = (layer["x"].to(dtype), layer["w"].to(dtype), layer["bias"], layer["beta"],
                layer["gamma"], inverse)
        got = convt_igdn_emulated(*args)
        ref = convt_igdn.conv_transpose_igdn_up2_plain(*args)
        err = float((got.float() - ref.float()).abs().max() / ref.float().abs().max())
        assert got.shape == ref.shape and err <= CARD_RTOL[dtype], (tuple(args[0].shape), err)
