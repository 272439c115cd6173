"""The port's SGA landscape (``tools/sga_landscape.py``, the paper's Fig. 2),
the trajectory recording of ``LatentOptimizer.optimize``, the symmetric
``HyperSynthesisTransform`` and ``standardized_quantile``, against nic_tpu on
the CPU at nf=8 on a 64x64 photo crop.

nic_tpu's script (scripts/sga_landscape.py) computes inline in its main, so
these tests run its steps as it does: the SGA trajectory by driving
``_init_carry`` and ``_optimize_chunk`` chunk by chunk, the argsort of the
two coordinates moved most, ``sga_relax`` with the keys
``fold_in(PRNGKey(seed), 1000 + i)``, and the grid through
``_rd_loss(..., "map")`` of ``y_flat.at[c].set``, vmapped in chunks of 32.
The port is fed JAX's Gumbel draws (``test_torch_engine.jax_gumbel_fn``).

Tolerances: the trajectory 1e-5 relative (max-norm, as the engine's tests),
the transmitted latents equal; the grid 1e-5 in float32 and ``LATENT_RTOL``
2e-3 with the bf16 transforms (``test_torch_bf16.py``: bf16 convolutions
round their float32 sums in another order; held against nic_tpu's Pallas
GDN, K1's semantics); the samples 1e-6; ``HyperSynthesisTransform`` 1e-5;
the quantile exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from nic_tpu.infer.engine import Latents as JaxLatents
from nic_tpu.infer.engine import _amortized_init as jax_amortized_init
from nic_tpu.infer.engine import _init_carry, _optimize_chunk
from nic_tpu.infer.engine import _rd_loss as jax_rd_loss
from nic_tpu.infer.methods import SGA as JAX_SGA
from nic_tpu.models.mbt2018 import MeanScaleHyperprior as JaxMBT
from nic_tpu.models.transforms import HyperSynthesisTransform as JaxHyperSynthesis
from nic_tpu.ops.quantize import sga_relax as jax_sga_relax
from nic_tpu.ops.schedules import annealed_temperature as jax_annealed_temperature
from nic_tpu.ops.stats import standardized_quantile as jax_standardized_quantile
from nic_tpu_torch.checkpoint import (
    export_params_npz,
    module_params_from_jax,
    params_from_jax,
)
from nic_tpu_torch.infer.engine import LatentOptimizer
from nic_tpu_torch.infer.methods import SGA
from nic_tpu_torch.models.mbt2018 import MeanScaleHyperprior
from nic_tpu_torch.models.transforms import HyperSynthesisTransform
from nic_tpu_torch.ops.schedules import annealed_temperature
from nic_tpu_torch.ops.stats import standardized_quantile
from nic_tpu_torch.tools import sga_landscape

from test_torch_engine import assert_rel, jax_gumbel_fn

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHOTOS = os.path.join(ROOT, "data_real", "eval_photos.npy")
NF = 8
LMBDA = 0.01
SEED = 0
ITS = 6
RECORD_EVERY = 2
GRID = 5
TRAJECTORY_RTOL = 1e-5
GRID_RTOL = 1e-5
LATENT_RTOL = 2e-3
SAMPLE_ATOL = 1e-6


def _flat(params):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}


@pytest.fixture(scope="module")
def flat():
    return _flat(JaxMBT(num_filters=NF).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), training=True,
        rng=jax.random.PRNGKey(1))["params"])


@pytest.fixture(scope="module")
def image():
    return (np.load(PHOTOS)[:1, 100:164, 200:264].astype(np.float32) / 255.0)


def _port_model(flat, dtype=torch.float32):
    model = MeanScaleHyperprior(NF, dtype)
    model.load_state_dict(params_from_jax(flat))
    return model


def _jax_params(flat):
    return traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                         for k, v in flat.items()})


def landscape_noise_fn(seed, steps):
    """The SGA loop's draws (``jax_gumbel_fn``) and the samples', those of
    ``fold_in(PRNGKey(seed), 1000 + i)`` as nic_tpu's script draws them."""
    loop = jax_gumbel_fn(seed, steps)
    rng = jax.random.PRNGKey(seed)

    def fn(step, name, shape):
        if name == "sample":
            key = jax.random.fold_in(rng, 1000 + step)
            return torch.tensor(np.asarray(jax.random.gumbel(key, shape)))
        return loop(step, name, shape)

    return fn


@pytest.fixture(scope="module")
def jax_trajectory(flat, image):
    """nic_tpu's script's steps 1-2: the trajectory rows and the final
    continuous latents, chunk by chunk of RECORD_EVERY steps."""
    model, params = JaxMBT(num_filters=NF), _jax_params(flat)
    x = jnp.asarray(image)
    method = JAX_SGA.replace(iterations=ITS)
    y0, z0 = jax_amortized_init(model, params, x)
    carry = _init_carry(JaxLatents(y=y0, z=z0), jax.random.PRNGKey(SEED))
    traj, its_done = [np.asarray(carry.latents.y).ravel()], 0
    while its_done < method.iterations:
        this = min(RECORD_EVERY, method.iterations - its_done)
        carry, _, _ = _optimize_chunk(model, params, x, jnp.float32(LMBDA), method, this,
                                      carry, 0, 1)
        its_done += this
        traj.append(np.asarray(carry.latents.y).ravel())
    return np.stack(traj), np.asarray(carry.latents.y), np.asarray(carry.latents.z)


@pytest.fixture(scope="module")
def land(flat, image):
    return sga_landscape.landscape(
        _port_model(flat), image, LMBDA, SGA.replace(iterations=ITS), RECORD_EVERY, GRID,
        1.2, SEED, noise_fn=landscape_noise_fn(SEED, ITS), device="cpu")


def _jax_grid(jmodel, flat, image, y_star, z_star, coords, g1, g2):
    """nic_tpu's script's step 4 on the given y*, z*, coordinates and axes."""
    params = _jax_params(flat)
    c1, c2 = coords
    y_flat = jnp.asarray(np.asarray(y_star).ravel())
    x = jnp.asarray(image)

    @jax.jit
    def loss_at(v1, v2):
        y = y_flat.at[c1].set(v1).at[c2].set(v2).reshape(y_star.shape)
        loss, _ = jax_rd_loss(jmodel, params, JaxLatents(y=y, z=jnp.asarray(z_star)), x,
                              jnp.float32(LMBDA), jnp.float32(1.0), jax.random.PRNGKey(0),
                              "map")
        return loss

    vv1, vv2 = np.meshgrid(g1, g2)
    flat1, flat2 = vv1.ravel(), vv2.ravel()
    batched = jax.jit(jax.vmap(loss_at))
    zz = [np.asarray(batched(jnp.asarray(flat1[i:i + 32]), jnp.asarray(flat2[i:i + 32])))
          for i in range(0, flat1.size, 32)]
    return np.concatenate(zz).reshape(vv1.shape)


# ------------------------------------------------------------- trajectory


def test_trajectory_matches_nic_tpus_chunked_loop(flat, image, jax_trajectory):
    traj, y_end, z_end = jax_trajectory
    res = LatentOptimizer(_port_model(flat), "cpu").optimize(
        image, LMBDA, method=SGA.replace(iterations=ITS), seed=SEED,
        noise_fn=jax_gumbel_fn(SEED, ITS), record_every=RECORD_EVERY)
    got = res["trajectory_y"]
    assert got.shape == (ITS // RECORD_EVERY + 1,) + y_end.shape
    for row, ref in zip(got.reshape(got.shape[0], -1), traj):
        assert_rel(row, ref, TRAJECTORY_RTOL)
    np.testing.assert_array_equal(res["y"], np.round(y_end))
    np.testing.assert_array_equal(res["z"], np.round(z_end))
    m = JAX_SGA
    want = [float(jax_annealed_temperature(s - 1, r=m.annealing_rate, ub=m.temperature_ub,
                                           scheme=m.annealing_scheme, t0=m.t0))
            for s in (2, 4, 6)]
    assert np.isnan(res["trajectory_temperatures"][0])
    np.testing.assert_array_equal(res["trajectory_temperatures"][1:], np.float32(want))


def test_trajectory_rows_are_the_loop_itself(flat, image):
    """record_every > 0 changes no step: the losses and latents are those
    of the same run without it, and row 0 is the amortized y. With
    record_every=0 no trajectory key is returned."""
    opt = LatentOptimizer(_port_model(flat), "cpu")
    spec = SGA.replace(iterations=5)
    plain = opt.optimize(image, LMBDA, method=spec, noise_fn=jax_gumbel_fn(0, 5))
    rec = opt.optimize(image, LMBDA, method=spec, noise_fn=jax_gumbel_fn(0, 5),
                       record_every=3)
    assert not any(k.startswith("trajectory") for k in plain)
    assert set(rec) - set(plain) == {"trajectory_y", "trajectory_z",
                                     "trajectory_temperatures"}
    for k in plain:
        np.testing.assert_array_equal(rec[k], plain[k])
    assert rec["trajectory_y"].shape[0] == 3  # after steps 0, 3 and 5
    m = SGA
    want = [annealed_temperature(s, r=m.annealing_rate, ub=m.temperature_ub,
                                 scheme=m.annealing_scheme, t0=m.t0) for s in (2, 4)]
    np.testing.assert_array_equal(rec["trajectory_temperatures"][1:], np.float32(want))
    y0, z0 = opt.amortized_init(image)
    np.testing.assert_array_equal(rec["trajectory_y"][0], y0.numpy())
    np.testing.assert_array_equal(rec["trajectory_z"][0], z0.numpy())


# -------------------------------------------------------------- landscape


def test_coordinates_are_nic_tpus_argsort_choice(land, jax_trajectory):
    traj = jax_trajectory[0]
    move = np.abs(traj[-1] - traj[0])
    c1, c2 = np.argsort(move)[-2:][::-1]
    assert land["coords"] == (int(c1), int(c2))
    assert_rel(land["t1"], traj[:, c1], TRAJECTORY_RTOL)
    assert_rel(land["t2"], traj[:, c2], TRAJECTORY_RTOL)


def test_samples_match_nic_tpus_sga_relax(land):
    rng = jax.random.PRNGKey(SEED)
    ref = []
    for i in range(1, land["trajectory"].shape[0]):
        pair = jnp.asarray([land["t1"][i], land["t2"][i]], jnp.float32)
        ref.append(np.asarray(jax_sga_relax(pair, jnp.float32(land["temperatures"][i]),
                                            jax.random.fold_in(rng, 1000 + i))))
    assert land["samples"].shape == (ITS // RECORD_EVERY, 2)
    np.testing.assert_allclose(land["samples"], np.stack(ref), rtol=0, atol=SAMPLE_ATOL)


def test_grid_matches_nic_tpus_map_objective_fp32(flat, image, land):
    res = land["result"]
    ref = _jax_grid(JaxMBT(num_filters=NF), flat, image, res["trajectory_y"][-1],
                    res["trajectory_z"][-1], land["coords"], land["g1"], land["g2"])
    assert land["objective"].shape == (GRID, GRID)
    assert np.all(np.isfinite(land["objective"]))
    assert np.ptp(land["objective"]) > 0
    assert_rel(land["objective"], ref, GRID_RTOL)


def test_grid_matches_nic_tpus_map_objective_bf16(flat, image):
    """The script's bf16 model, on the amortized latents and a grid over two
    coordinates wide enough to move the objective."""
    model = _port_model(flat, torch.bfloat16)
    opt = LatentOptimizer(model, "cpu")
    y0, z0 = opt.amortized_init(image)
    coords = (5, 77)
    g1 = np.linspace(-3.0, 3.0, GRID)
    g2 = np.linspace(-2.0, 4.0, GRID)
    vv1, vv2 = np.meshgrid(g1, g2)
    got = sga_landscape.objective_at(model, torch.tensor(image), y0, z0, coords,
                                     vv1.ravel(), vv2.ravel(), LMBDA).reshape(vv1.shape)
    jmodel = JaxMBT(num_filters=NF, compute_dtype=jnp.bfloat16, use_pallas_gdn=True)
    ref = _jax_grid(jmodel, flat, image, y0.numpy(), z0.numpy(), coords, g1, g2)
    assert np.ptp(ref) > 0
    assert_rel(got, ref, LATENT_RTOL)
    # The objective's relief is a small part of its value: hold the relief
    # itself at the same tolerance of its range.
    assert_rel(got - got.min(), ref - ref.min(), LATENT_RTOL)


def test_objective_in_a_batch_equals_alone(flat, image, land):
    """Each copy of a batch is its own objective: a point evaluated among
    others equals it evaluated alone."""
    model = _port_model(flat)
    res = land["result"]
    y_star, z_star = (torch.tensor(res[k][-1]) for k in ("trajectory_y", "trajectory_z"))
    v1 = np.concatenate([[land["t1"][-1]], land["g1"]])
    v2 = np.concatenate([[land["t2"][-1]], land["g2"]])
    args = (model, torch.tensor(image), y_star, z_star, land["coords"])
    batched = sga_landscape.objective_at(*args, v1, v2, LMBDA)
    alone = sga_landscape.objective_at(*args, v1[:1], v2[:1], LMBDA)
    assert_rel(batched[:1], alone, 1e-6)
    assert len(set(batched.tolist())) > 1


def test_main_writes_the_figure(flat, image, tmp_path):
    run = "mbt2018-num_filters=8-lmbda=0.01"
    os.makedirs(tmp_path / run)
    export_params_npz(str(tmp_path / run), 0, flat)
    np.save(tmp_path / "crop.npy", (image * 255).round().astype(np.uint8))
    out = tmp_path / "fig" / "sga_landscape.png"
    land = sga_landscape.main([str(tmp_path / "crop.npy"), "--checkpoint_dir", str(tmp_path),
                               "--runname", run, "--num_filters", str(NF), "--its", "4",
                               "--record_every", "2", "--grid", "3", "--out", str(out),
                               "--device", "cpu"])
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert land["objective"].shape == (3, 3) and land["samples"].shape == (2, 2)


def test_main_needs_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sga_landscape.main([str(tmp_path / "none.npy"), "--out", str(tmp_path / "f.png")])


# ---------------------------------------------------------- small pieces


@pytest.mark.parametrize("num_output_filters", [None, 2 * NF])
def test_hyper_synthesis_transform_matches_nic_tpus(num_output_filters):
    jmod = JaxHyperSynthesis(num_filters=NF, num_output_filters=num_output_filters)
    z = np.random.default_rng(3).normal(size=(2, 4, 6, NF)).astype(np.float32)
    params = jmod.init(jax.random.PRNGKey(4), jnp.asarray(z))["params"]
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(z)))
    with torch.device("meta"):
        template = HyperSynthesisTransform(NF, num_output_filters)
    model = HyperSynthesisTransform(NF, num_output_filters)
    model.load_state_dict(module_params_from_jax(template, _flat(params)))
    with torch.no_grad():
        got = model(torch.tensor(z))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    assert_rel(got, ref, 1e-5)


@pytest.mark.parametrize("p", [2 ** -9, 1e-9 / 2, 0.3, 0.975])
def test_standardized_quantile_equals_nic_tpus(p):
    assert standardized_quantile(p) == jax_standardized_quantile(p)
