"""The models' training half, the port against nic_tpu, on the CPU: the
training forward and the loss of MBT2018 (``rd_loss`` plus the quantile
loss) and of the bits-back model (``bb_rd_loss``), every metric, and every
parameter's gradient against ``jax.grad`` of nic_tpu's Trainer objective;
the MS-SSIM objective; the quantile loss alone; and K1's backward (the one
the card runs, ``gdn_backward``) through the GDN reparameterization at a
fresh init, where gamma's off-diagonals sit exactly at their bound.

Both sides get nic_tpu's own noise (``train_parity.jax_noise``) and the
same parameters (``params_from_jax``): a fresh nic_tpu init at nf=8, and
the committed nf=192 lambda=0.01 checkpoints on one 64x64 photo crop.

Tolerances: the loss and the metrics 1e-5 relative (float32 sums in
another order); each parameter's gradient 1e-4 of that gradient's largest
magnitude (elementwise, max-norm relative; the repo's float32 gradient
tolerance).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nic_tpu.models.layers import GDN as JaxGDN
from nic_tpu.train.checkpoint import load_params_npz as jax_load_params_npz
from nic_tpu_torch.checkpoint import latest_npz
from nic_tpu_torch.models.factorized_prior import FactorizedEntropyModel
from nic_tpu_torch.models.layers import GDN
from nic_tpu_torch.ops import gdn_cuda
from train_parity import (assert_rel, flat, jax_loss_and_grads, jax_noise, jax_trainer,
                          nest, port_loss_and_grads, port_trainer)

torch.set_num_threads(1)

VALUE_RTOL = 1e-5
GRAD_RTOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT_DIR = os.path.join(ROOT, "checkpoints_synth3")
PHOTOS = os.path.join(ROOT, "data_real", "eval_photos.npy")


def _check(model, nf, params, x, lmbda=0.01, distortion="mse", step=0):
    """The port's objective and gradients against nic_tpu's at ``params``."""
    batch, patch = x.shape[0], x.shape[1]
    jtrainer, state = jax_trainer(model, num_filters=nf, lmbda=lmbda, batchsize=batch,
                                  patchsize=patch, distortion=distortion)
    params = state.params if params is None else params
    rng = jax.random.fold_in(state.rng, step)
    ref_metrics, ref_grads = jax_loss_and_grads(jtrainer, params, jnp.asarray(x), rng)
    trainer = port_trainer(model, flat(params), num_filters=nf, lmbda=lmbda,
                           batchsize=batch, patchsize=patch, distortion=distortion)
    noise = jax_noise(model, state.rng, step, batch, patch, nf)
    metrics, grads = port_loss_and_grads(trainer, x, noise)
    assert set(metrics) == set(ref_metrics)
    for k, v in ref_metrics.items():
        assert_rel(metrics[k], v, VALUE_RTOL, k)
    assert set(grads) == set(ref_grads)
    kink = _quantile_loss_kinks(trainer.model) if model == "mbt2018" else None
    for k, g in ref_grads.items():
        assert grads[k].shape == g.shape, k
        if k == "entropy_bottleneck/quantiles":
            # |logit - target| has no derivative at 0, where a converged
            # quantile sits: there the gradient is -g, 0 or g by float32
            # rounding. It is held everywhere else.
            assert np.count_nonzero(kink) <= 0.05 * kink.size
            assert_rel(grads[k][~kink], g[~kink], GRAD_RTOL, k)
        else:
            assert_rel(grads[k], g, GRAD_RTOL, k)
    return grads


def _quantile_loss_kinks(model):
    """Where the quantile loss's |logit - target| is within float32
    rounding of its kink: 1e-5, a few ulps of the tail logits (~21.4)."""
    prior = model.entropy_bottleneck
    target = np.log(2.0 / prior.tail_mass - 1.0)
    with torch.no_grad():
        logits = prior._logits_cdf(prior.quantiles, stop_gradient=True).numpy()
    return np.abs(logits - np.array([-target, 0.0, target])) <= 1e-5


def _images(batch, patch, seed=0):
    return np.random.default_rng(seed).random((batch, patch, patch, 3), dtype=np.float32)


@pytest.mark.parametrize("model", ["mbt2018", "mbt2018_bb"])
def test_fresh_init_loss_and_every_gradient_match_nic_tpu(model):
    """nf=8, batch 2, patch 64, nic_tpu's fresh init, two steps' noise."""
    x = _images(2, 64)
    for step in (0, 1):
        grads = _check(model, 8, None, x, step=step)
    # Fresh GDN gammas: off-diagonals at the bound still receive gradient.
    g = grads["analysis/gdn_0/gamma"]
    assert np.count_nonzero(g - np.diag(np.diag(g))) > 0


@pytest.mark.parametrize("model", ["mbt2018", "mbt2018_bb"])
def test_committed_checkpoint_loss_and_every_gradient_match_nic_tpu(model):
    """The committed nf=192 lambda=0.01 checkpoints on one 64x64 photo crop."""
    run = f"{model}-num_filters=192-lmbda=0.01"
    _, params = jax_load_params_npz(latest_npz(os.path.join(CKPT_DIR, run)))
    x = np.load(PHOTOS)[:1, 100:164, 200:264].astype(np.float32) / 255.0
    _check(model, 192, nest(flat(params)), x)


def test_msssim_objective_and_gradients_match_nic_tpu():
    """--distortion msssim at patch 192 (MS-SSIM's five scales)."""
    _check("mbt2018", 8, None, _images(1, 192, seed=1), lmbda=3.0, distortion="msssim")


def test_aux_loss_reaches_the_quantiles_only():
    jtrainer, state = jax_trainer("mbt2018", num_filters=8, patchsize=64, batchsize=1)
    model = jtrainer.model
    params = jax.tree.map(lambda a: a, state.params)
    # Move the quantiles off their init so the loss is not at its kink.
    q = params["entropy_bottleneck"]["quantiles"]
    params["entropy_bottleneck"]["quantiles"] = q + 0.3 * jnp.arange(q.size).reshape(q.shape) / q.size
    ref, ref_grads = jax.value_and_grad(
        lambda p: model.apply({"params": p}, method=model.aux_loss))(params)
    trainer = port_trainer("mbt2018", flat(params), num_filters=8, patchsize=64, batchsize=1)
    aux = trainer.model.aux_loss()
    aux.backward()
    assert_rel(float(aux), float(ref), VALUE_RTOL)
    ref_grads = flat(ref_grads)
    for name, p in trainer.model.named_parameters():
        if name == "entropy_bottleneck.quantiles":
            assert_rel(p.grad.numpy(), ref_grads["entropy_bottleneck/quantiles"], GRAD_RTOL)
        else:
            assert p.grad is None, name
    for k, g in ref_grads.items():
        if k != "entropy_bottleneck/quantiles":
            assert not np.any(g), k


def test_prior_cdf_pdf_logpdf_and_parameter_gradients():
    """cdf_pdf and logpdf of the prior, and reverse mode through the pdf's
    forward-mode derivative reaching the prior's parameters, against
    nic_tpu's FactorizedEntropyModel."""
    from nic_tpu.models.factorized_prior import FactorizedEntropyModel as JaxPrior

    x = np.random.default_rng(2).normal(0, 2, (5, 7, 4)).astype(np.float32)
    jmodel = JaxPrior(channels=4)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), training=False)["params"]
    cdf_ref, pdf_ref = jmodel.apply({"params": params}, jnp.asarray(x), method=jmodel.cdf_pdf)
    logpdf_ref, grads_ref = jax.value_and_grad(lambda p: jnp.sum(jmodel.apply(
        {"params": p}, jnp.asarray(x), method=jmodel.logpdf)))(params)
    model = FactorizedEntropyModel(4)
    model.load_state_dict({k: torch.tensor(v) for k, v in flat(params).items()})
    cdf, pdf = model.cdf_pdf(torch.tensor(x))
    assert_rel(cdf.detach(), cdf_ref, VALUE_RTOL)
    assert_rel(pdf.detach(), pdf_ref, VALUE_RTOL)
    total = torch.sum(model.logpdf(torch.tensor(x)))
    total.backward()
    assert_rel(float(total), float(logpdf_ref), VALUE_RTOL)
    grads_ref = flat(grads_ref)
    for name, p in model.named_parameters():
        if name == "quantiles":
            assert p.grad is None
        else:
            assert_rel(p.grad, grads_ref[name], GRAD_RTOL, name)


@pytest.mark.parametrize("inverse", [False, True])
def test_k1_backward_through_the_reparameterization_at_init(inverse):
    """K1's backward (``gdn_backward``, what the card runs after the
    kernel's forward) through ``GDN.effective_params`` at a fresh init:
    the raw beta's and gamma's gradients against nic_tpu's GDN layer.
    gamma's off-diagonals sit exactly at their bound 2^-18, where the
    bound's gradient passes (``>=``), so they get nonzero gradients."""
    x = np.random.default_rng(4).normal(0, 2, (2, 8, 8, 16)).astype(np.float32)
    w = np.random.default_rng(5).normal(0, 1, x.shape).astype(np.float32)
    jlayer = JaxGDN(inverse=inverse)
    params = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    ref = flat(jax.grad(lambda p: jnp.sum(jlayer.apply({"params": p}, jnp.asarray(x)) * w))(
        params))

    layer = GDN(16, inverse=inverse)
    assert bool(torch.all(layer.gamma[~torch.eye(16, dtype=torch.bool)] == 2.0 ** -18))
    beta, gamma = layer.effective_params()
    _, dgamma, dbeta = gdn_cuda.gdn_backward(
        torch.tensor(x).reshape(-1, 16), gamma.detach(), beta.detach(),
        torch.tensor(w).reshape(-1, 16), inverse)
    torch.autograd.backward([gamma, beta], [dgamma, dbeta])
    assert_rel(layer.beta.grad, ref["beta"], GRAD_RTOL)
    assert_rel(layer.gamma.grad, ref["gamma"], GRAD_RTOL)
    off = ~np.eye(16, dtype=bool)
    assert np.count_nonzero(layer.gamma.grad.numpy()[off]) > 0


def test_eval_bpp_matches_nic_tpu():
    """The per-image rate split of the evaluation forward, on the committed
    nf=192 checkpoint and two 64x64 photo crops."""
    from nic_tpu.models.mbt2018 import MeanScaleHyperprior as JaxMBT
    from nic_tpu.models.mbt2018 import eval_bpp as jax_eval_bpp
    from nic_tpu_torch.checkpoint import load_model
    from nic_tpu_torch.models.mbt2018 import eval_bpp

    run = "mbt2018-num_filters=192-lmbda=0.01"
    _, params = jax_load_params_npz(latest_npz(os.path.join(CKPT_DIR, run)))
    x = np.load(PHOTOS)[:2, 100:164, 200:264].astype(np.float32) / 255.0
    ref = jax_eval_bpp(JaxMBT(num_filters=192).apply(
        {"params": nest(flat(params))}, jnp.asarray(x), training=False), 64 * 64)
    _, model = load_model(CKPT_DIR, run, 192, "cpu")
    with torch.no_grad():
        got = eval_bpp(model(torch.tensor(x)), 64 * 64)
    for g, r in zip(got, ref):
        assert g.shape == (2,)
        assert_rel(g, np.asarray(r), VALUE_RTOL)
