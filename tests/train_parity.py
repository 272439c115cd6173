"""What the port's training tests share: nic_tpu's training noise, loss and
gradients, and the mapping of parameters between the two packages.

JAX and torch draw different random numbers, so the port is fed nic_tpu's
own draws: step ``s`` of nic_tpu's Trainer folds ``s`` into its state's key,
splits it into (rng_z, rng_y) (bits-back: (rng_eps, rng_y)), and the forward
draws U(-.5, .5) (bits-back: N(0, 1) for eps) from the first and U(-.5, .5)
for y from the second.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import traverse_util

from nic_tpu.models.mbt2018 import rd_loss as jax_rd_loss
from nic_tpu.models.mbt2018_bb import bb_rd_loss as jax_bb_rd_loss
from nic_tpu.train.trainer import TrainConfig as JaxTrainConfig
from nic_tpu.train.trainer import Trainer as JaxTrainer
from nic_tpu_torch.checkpoint import params_to_jax
from nic_tpu_torch.train.trainer import TrainConfig, Trainer


def assert_rel(actual, expected, rtol, what=""):
    """Elementwise, with an absolute floor of ``rtol`` times the largest
    reference magnitude."""
    actual = np.asarray(actual, np.float64)
    expected = np.asarray(expected, np.float64)
    floor = rtol * max(float(np.nanmax(np.abs(expected), initial=0.0)), 1e-30)
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=floor, err_msg=what)


def flat(params):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}


def nest(flat_params):
    return traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat_params.items()},
                                        sep="/")


def shapes(batch, patch, nf):
    """(y's, z's) shapes of a training batch."""
    return (batch, patch // 16, patch // 16, nf), (batch, patch // 64, patch // 64, nf)


def jax_noise(model, state_rng, step, batch, patch, nf):
    """nic_tpu's draws of step ``step`` as the port's ``noise`` pair."""
    y_shape, z_shape = shapes(batch, patch, nf)
    first, second = jax.random.split(jax.random.fold_in(state_rng, step))
    if model == "mbt2018":
        a = jax.random.uniform(first, z_shape, jnp.float32, -0.5, 0.5)
    else:
        a = jax.random.normal(first, z_shape, jnp.float32)
    b = jax.random.uniform(second, y_shape, jnp.float32, -0.5, 0.5)
    return torch.tensor(np.asarray(a)), torch.tensor(np.asarray(b))


def jax_trainer(model="mbt2018", **kw):
    """nic_tpu's Trainer on one device and its initial state."""
    trainer = JaxTrainer(JaxTrainConfig(model=model, num_devices=1, **kw))
    return trainer, trainer.init_state()


def port_trainer(model="mbt2018", flat_params=None, **kw):
    """The port's Trainer on the CPU, with nic_tpu's parameters if given."""
    trainer = Trainer(TrainConfig(model=model, **kw), device="cpu")
    if flat_params is not None:
        trainer.load_params(flat_params)
    return trainer


def jax_loss_and_grads(jtrainer, params, x, rng):
    """nic_tpu's Trainer objective (RD loss, plus the quantile loss for
    MBT2018) at ``params`` on float images ``x``: (metrics, flat grads)."""
    cfg, model = jtrainer.cfg, jtrainer.model
    loss_impl = jax_rd_loss if cfg.model == "mbt2018" else jax_bb_rd_loss

    def loss_fn(p):
        out = model.apply({"params": p}, x, training=True, rng=rng)
        loss, metrics = loss_impl(out, x, cfg.lmbda, cfg.distortion)
        if cfg.model == "mbt2018":
            aux = model.apply({"params": p}, method=model.aux_loss)
            metrics = dict(metrics, aux_loss=aux)
            loss = loss + aux
        return loss, metrics

    grads, metrics = jax.grad(loss_fn, has_aux=True)(params)
    return {k: float(v) for k, v in metrics.items()}, flat(grads)


def port_loss_and_grads(trainer, x, noise):
    """The port's objective and every parameter's gradient (zeros where none
    reaches), under nic_tpu's keys and layouts."""
    trainer.model.zero_grad(set_to_none=True)
    loss, metrics = trainer.loss(torch.tensor(x), noise)
    loss.backward()
    grads = {name: (p.grad if p.grad is not None else torch.zeros_like(p))
             for name, p in trainer.model.named_parameters()}
    return ({k: float(v) for k, v in metrics.items()},
            params_to_jax(grads, trainer.cfg.model))
