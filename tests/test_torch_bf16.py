"""The port's bf16 transforms against nic_tpu's, on the CPU.

nic_tpu's ``MeanScaleHyperprior(compute_dtype=jnp.bfloat16)`` casts each
conv's input and kernel to bf16, adds the bias in bf16, runs its GDN on bf16
activations and returns float32 from each transform; the port does the same.
With ``use_pallas_gdn=True`` (the Pallas kernel, in interpret mode off the
TPU, as nic_tpu's own tests run it) the GDN semantics are K1's: x^2 and
gamma in bf16, the normalizer in float32.

Tolerances (max-norm relative unless said otherwise):
- against the Pallas route, on the committed checkpoint and a photo crop:
  y and z 2e-3 (a few bf16 ulps: XLA's bf16 conv and torch's round their
  float32 sums in another order; measured 3e-4); at most 0.5 % of the
  rounded y and z differing (an ulp can move a value across a rounding
  boundary: none or one of 3072 measured, with XLA's optimization level as
  the difference); est. bpp 1e-3; x_tilde 5e-2 (7e-3 measured with no
  flip, 2.2e-2 with one). Fed nic_tpu's own rounded latents: mu, sigma and
  both likelihoods 1e-5 elementwise (measured 2e-7), x_tilde 1.6e-2, four
  bf16 ulps;
- against the default XLA GDN, which rounds the normalizer's 1x1 conv and
  the scale to bf16 by design (nic_tpu/ops/gdn.py): est. bpp 0.5 %, y 1e-2,
  x_tilde 0.1, and at least 99 % of y_tilde equal (measured 6e-4, 2e-3,
  4e-2 and 99.7 %);
- k bf16 SGA steps against nic_tpu with JAX's Gumbel draws (nf=16, the
  Pallas route): losses and eval metrics 1e-3 elementwise, at most 1 % of
  the transmitted latents differing (measured 3e-6 and none). XLA fuses the
  jitted loop's bf16 ops and rounds some intermediates elsewhere than its
  own op-by-op run; on the nf=192 photo crop that alone moves the loss by
  2e-3.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from nic_tpu.infer.engine import LatentOptimizer as JaxLatentOptimizer
from nic_tpu.infer.methods import SGA as JAX_SGA
from nic_tpu.models.mbt2018 import MeanScaleHyperprior as JaxMBT
from nic_tpu.models.mbt2018 import eval_bpp as jax_eval_bpp
from nic_tpu.train.checkpoint import load_params_npz as jax_load_params_npz
from nic_tpu_torch.checkpoint import latest_npz, load_model, params_from_jax
from nic_tpu_torch.infer.engine import LatentOptimizer
from nic_tpu_torch.infer.methods import SGA
from nic_tpu_torch.models.layers import GDN, SignalConv
from nic_tpu_torch.models.mbt2018 import LN2, MeanScaleHyperprior

from test_torch_engine import jax_gumbel_fn

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT_DIR = os.path.join(ROOT, "checkpoints_synth3")
RUN = "mbt2018-num_filters=192-lmbda=0.01"
PHOTOS = os.path.join(ROOT, "data_real", "eval_photos.npy")
LATENT_RTOL = 2e-3
EXACT_RTOL = 1e-5
X_TILDE_RTOL = 1.6e-2
X_TILDE_FLIPPED_RTOL = 5e-2
EXACT_KEYS = ("z_tilde", "z_likelihoods", "mu", "sigma", "y_tilde", "y_likelihoods")
MAX_ROUNDINGS_FLIPPED = 0.005
BPP_RTOL = 1e-3
SGA_RTOL = 1e-3
MAX_LATENTS_DIFFERING = 0.01


def max_rel(actual, expected):
    actual = np.asarray(actual, np.float64)
    expected = np.asarray(expected, np.float64)
    return float(np.abs(actual - expected).max() / np.abs(expected).max())


def assert_rel(actual, expected, rtol):
    actual = np.asarray(actual, np.float64)
    expected = np.asarray(expected, np.float64)
    floor = rtol * max(float(np.abs(expected).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=floor)


def est_bpp(out, num_pixels):
    bits = -(torch.sum(torch.log(out["y_likelihoods"]), dim=(1, 2, 3))
             + torch.sum(torch.log(out["z_likelihoods"]), dim=(1, 2, 3)))
    return (bits / (LN2 * num_pixels)).numpy()


@pytest.fixture(scope="module")
def committed():
    """The port's bf16 model on the committed checkpoint, a photo crop, and
    its forward."""
    _, jparams = jax_load_params_npz(latest_npz(os.path.join(CKPT_DIR, RUN)))
    _, model = load_model(CKPT_DIR, RUN, 192, "cpu", compute_dtype=torch.bfloat16)
    x = np.load(PHOTOS)[:1, 100:164, 200:264].astype(np.float32) / 255.0
    with torch.no_grad():
        out = model(torch.tensor(x))
    return jparams, x, out


def _jax_forward(jparams, x, use_pallas_gdn):
    jmodel = JaxMBT(num_filters=192, compute_dtype=jnp.bfloat16,
                    use_pallas_gdn=use_pallas_gdn)
    return jmodel.apply({"params": jparams}, jnp.asarray(x), training=False)


def test_bf16_forward_matches_the_pallas_gdn_route(committed):
    """The whole forward, then each sub-pass on nic_tpu's own rounded
    latents, so that a rounding of y or z that the two sides' last-ulp
    differences flip is held apart from the passes after it."""
    jparams, x, out = committed
    ref = _jax_forward(jparams, x, use_pallas_gdn=True)
    for k in ("y", "z") + EXACT_KEYS + ("x_tilde",):
        assert out[k].dtype == torch.float32 and tuple(out[k].shape) == ref[k].shape, k
    assert max_rel(out["y"], ref["y"]) <= LATENT_RTOL
    assert max_rel(out["z"], ref["z"]) <= LATENT_RTOL
    for k in ("z_tilde", "y_tilde"):
        assert np.mean(out[k].numpy() != np.asarray(ref[k])) <= MAX_ROUNDINGS_FLIPPED, k
    assert max_rel(out["x_tilde"], ref["x_tilde"]) <= X_TILDE_FLIPPED_RTOL
    assert_rel(est_bpp(out, 64 * 64), jax_eval_bpp(ref, 64 * 64)[0], BPP_RTOL)

    model = load_model(CKPT_DIR, RUN, 192, "cpu", compute_dtype=torch.bfloat16)[1]
    t = lambda k: torch.tensor(np.asarray(ref[k]))  # noqa: E731
    with torch.no_grad():
        mu, sigma = model.hyper_synthesize(t("z_tilde"), tuple(ref["y"].shape[1:3]))
        assert_rel(mu, ref["mu"], EXACT_RTOL)
        assert_rel(sigma, ref["sigma"], EXACT_RTOL)
        assert_rel(model.z_likelihood(t("z_tilde")), ref["z_likelihoods"], EXACT_RTOL)
        assert_rel(model.y_likelihood(t("y_tilde"), t("mu"), t("sigma")),
                   ref["y_likelihoods"], EXACT_RTOL)
        x_tilde = model.synthesize(t("y_tilde"), x.shape[1:3])
    assert max_rel(x_tilde, ref["x_tilde"]) <= X_TILDE_RTOL


def test_bf16_forward_near_the_xla_gdn_route(committed):
    jparams, x, out = committed
    ref = _jax_forward(jparams, x, use_pallas_gdn=False)
    bpp, ref_bpp = est_bpp(out, 64 * 64), np.asarray(jax_eval_bpp(ref, 64 * 64)[0])
    assert np.all(np.abs(bpp - ref_bpp) <= 0.005 * ref_bpp)
    assert max_rel(out["y"], ref["y"]) <= 1e-2
    assert max_rel(out["x_tilde"], ref["x_tilde"]) <= 0.1
    assert np.mean(out["y_tilde"].numpy() == np.asarray(ref["y_tilde"])) >= 0.99


def test_bf16_sga_steps_match_jax():
    jmodel = JaxMBT(num_filters=16, compute_dtype=jnp.bfloat16, use_pallas_gdn=True)
    params = JaxMBT(num_filters=16).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), training=True,
        rng=jax.random.PRNGKey(1))["params"]
    flat = {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(params, sep="/").items()}
    model = MeanScaleHyperprior(16, compute_dtype=torch.bfloat16)
    model.load_state_dict(params_from_jax(flat))
    x = np.random.default_rng(7).random((2, 64, 64, 3)).astype(np.float32)
    steps = 5
    ref = JaxLatentOptimizer(jmodel, params).optimize(
        x, 0.01, method=JAX_SGA.replace(iterations=steps), seed=0)
    out = LatentOptimizer(model, "cpu").optimize(
        x, 0.01, method=SGA.replace(iterations=steps), seed=0,
        noise_fn=jax_gumbel_fn(0, steps))
    assert_rel(out["losses"], ref["losses"], SGA_RTOL)
    for k in ("y", "z"):
        assert np.mean(out[k] != ref[k]) <= MAX_LATENTS_DIFFERING
    for k in ("mse", "psnr", "est_bpp", "est_y_bpp", "est_z_bpp"):
        assert_rel(out[k], ref[k], SGA_RTOL)


def test_bf16_model_keeps_float32_parameters_and_runs_gdn_in_bf16():
    """Parameters, the transforms' outputs and the rate math stay float32;
    every conv and every GDN and IGDN layer computes in bf16, so on the card
    each GDN launches K1's bf16 route."""
    model = MeanScaleHyperprior(16, compute_dtype=torch.bfloat16).eval()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    seen = {}

    def record(module, args, output):
        seen[module] = (args[0].dtype, output.dtype)

    layers = [m for m in model.modules() if isinstance(m, (GDN, SignalConv))]
    assert sum(isinstance(m, GDN) for m in layers) == 6 and len(layers) == 20
    for m in layers:
        m.register_forward_hook(record)
    x = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = model(x)
    for m in layers:
        want_in = torch.float32 if (isinstance(m, SignalConv) and seen[m][0] ==
                                    torch.float32) else torch.bfloat16
        assert seen[m] == (want_in, torch.bfloat16), m
    for m in (model.analysis.gdn_0, model.synthesis.igdn_2):
        assert seen[m][0] == torch.bfloat16
    for k in ("y", "z", "mu", "sigma", "x_tilde", "y_likelihoods", "z_likelihoods"):
        assert out[k].dtype == torch.float32, k
    _, loaded = load_model(CKPT_DIR, RUN, 192, "cpu", compute_dtype=torch.bfloat16)
    assert loaded.compute_dtype == torch.bfloat16
    assert loaded.synthesis.igdn_0.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in loaded.parameters())
