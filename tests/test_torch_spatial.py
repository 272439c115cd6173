"""The port's row-sharded spatial inference (``parallel/spatial.py``) on the
CPU, 2 and 4 gloo ranks, against nic_tpu's ``SpatialLatentOptimizer`` on
``data_mesh(2)`` and ``data_mesh(4)`` and against the port's unsharded
engine. Each width's ranks run every case in one spawn
(``torch_dist_workers.spatial_cases``).

Tolerances: the amortized latents 2e-5 absolute, and for the optimized
methods at least 99.9 % of the rounded y equal and bpp and PSNR within 1e-3
(nic_tpu's own spatial tests: float32 sums in another order through Adam);
the probes 1e-3; map's continuous latents 0.05 (nic_tpu's). The halo
exchange's backward in float64: the sharded transforms' input gradients
within 1e-10 of the unsharded ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from nic_tpu.infer.methods import DANNEAL as JAX_DANNEAL
from nic_tpu.infer.methods import MAP as JAX_MAP
from nic_tpu.models.mbt2018 import MeanScaleHyperprior as JaxMBT
from nic_tpu.parallel.mesh import data_mesh
from nic_tpu.parallel.spatial import SpatialLatentOptimizer as JaxSpatial
from nic_tpu_torch.checkpoint import params_from_jax
from nic_tpu_torch.infer.engine import LatentOptimizer
from nic_tpu_torch.infer.methods import MAP, SGA
from nic_tpu_torch.parallel.mesh import spawn
from nic_tpu_torch.parallel.spatial import SpatialLatentOptimizer
from torch_dist_workers import SeededNoise, build_model, spatial_cases

torch.set_num_threads(1)

NF = 8
ITS = 25
INIT_ATOL = 2e-5
Y_EQUAL = 0.999
METRIC_RTOL = 1e-3
MAP_ATOL = 0.05
GRAD_RTOL = 1e-10
WIDTHS = (2, 4)


@pytest.fixture(scope="module")
def setup():
    jmodel = JaxMBT(num_filters=NF)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), training=True,
                         rng=jax.random.PRNGKey(1))["params"]
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}
    state = params_from_jax(flat)
    rng = np.random.default_rng(0)
    x = rng.random((1, 128, 64, 3), np.float32)
    x_odd = rng.random((1, 100, 72, 3), np.float32)
    grad_inputs = (torch.from_numpy(rng.normal(size=(1, 8, 4, NF))),
                   torch.from_numpy(rng.random((1, 128, 64, 3))),
                   torch.from_numpy(rng.normal(size=(1, 128, 64, 3))),
                   torch.from_numpy(rng.normal(size=(1, 8, 4, NF))))
    return dict(jmodel=jmodel, params=params, state=state, x=x, x_odd=x_odd,
                grad_inputs=grad_inputs)


@pytest.fixture(scope="module")
def ranks(setup):
    """{width: [each rank's results]}."""
    s = setup
    return {n: spawn(spatial_cases, n, (s["state"], s["x"], s["x_odd"], ITS, s["grad_inputs"]),
                     device="cpu")
            for n in WIDTHS}


@pytest.fixture(scope="module")
def nic_tpu(setup):
    """nic_tpu's spatial results on data_mesh(n)."""
    s = setup
    out = {}
    for n in WIDTHS:
        sp = JaxSpatial(s["jmodel"], s["params"], mesh=data_mesh(n))
        y0, z0 = sp.amortized_init(jnp.asarray(s["x"]))
        out[n] = dict(
            y0=np.asarray(y0), z0=np.asarray(z0),
            danneal=sp.optimize(s["x"], 0.01, method=JAX_DANNEAL.replace(iterations=ITS)),
            map=sp.optimize(s["x"], 0.01, method=JAX_MAP.replace(iterations=10,
                                                                 early_stop=False)),
            probes=sp.optimize(s["x"], 0.01, method=JAX_DANNEAL.replace(iterations=12),
                               probe_every=5, chunk_size=6),
            odd=sp.optimize(s["x_odd"], 0.01, method=JAX_DANNEAL.replace(iterations=8)),
        )
    return out


@pytest.fixture(scope="module")
def unsharded(setup):
    return LatentOptimizer(build_model(setup["state"]), "cpu")


def _assert_rounded_run_close(got, ref):
    assert got["y"].shape == ref["y"].shape
    assert np.mean(got["y"] == ref["y"]) >= Y_EQUAL
    np.testing.assert_allclose(got["est_bpp"], ref["est_bpp"], rtol=METRIC_RTOL)
    np.testing.assert_allclose(got["psnr"], ref["psnr"], rtol=METRIC_RTOL)


@pytest.mark.parametrize("n", WIDTHS)
def test_amortized_init_matches_nic_tpu(ranks, nic_tpu, n):
    got, ref = ranks[n][0], nic_tpu[n]
    np.testing.assert_allclose(got["y0"], ref["y0"], atol=INIT_ATOL)
    np.testing.assert_allclose(got["z0"], ref["z0"], atol=INIT_ATOL)


@pytest.mark.parametrize("n", WIDTHS)
def test_danneal_matches_nic_tpu(ranks, nic_tpu, n):
    got, ref = ranks[n][0]["danneal"], nic_tpu[n]["danneal"]
    _assert_rounded_run_close(got, ref)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=METRIC_RTOL)
    assert np.isnan(got["msssim"]).all()  # 128 x 64 is below MS-SSIM's 176


@pytest.mark.parametrize("n", WIDTHS)
def test_map_quantize_path_matches_nic_tpu(ranks, nic_tpu, n):
    """map transmits y centered on the mean from the continuous z, and z on
    the medians: continuous values, held as nic_tpu holds its own."""
    got, ref = ranks[n][0]["map"], nic_tpu[n]["map"]
    np.testing.assert_allclose(got["y"], ref["y"], atol=MAP_ATOL)
    np.testing.assert_allclose(got["z"], ref["z"], atol=MAP_ATOL)
    np.testing.assert_allclose(got["est_bpp"], ref["est_bpp"], rtol=METRIC_RTOL)
    assert got["x_tilde"].shape == (1, 128, 64, 3)


@pytest.mark.parametrize("n", WIDTHS)
def test_verbose_probes_match_nic_tpu(ranks, nic_tpu, n):
    got, ref = ranks[n][0]["probes"]["rounded_losses"], nic_tpu[n]["probes"]["rounded_losses"]
    assert got.shape == (12,)
    mask = np.isfinite(got)
    np.testing.assert_array_equal(mask, np.arange(12) % 5 == 0)
    np.testing.assert_array_equal(mask, np.isfinite(ref))
    np.testing.assert_allclose(got[mask], ref[mask], rtol=METRIC_RTOL)


@pytest.mark.parametrize("n", WIDTHS)
def test_non_aligned_image_pads_and_reports_original_pixels(ranks, nic_tpu, n, setup):
    got, ref = ranks[n][0]["odd"], nic_tpu[n]["odd"]
    assert got["x_tilde"].shape == setup["x_odd"].shape
    _assert_rounded_run_close(got, ref)
    np.testing.assert_allclose(got["mse"], ref["mse"], rtol=METRIC_RTOL)
    assert np.isnan(got["msssim"]).all() and np.isnan(got["msssim_db"]).all()


@pytest.mark.parametrize("n", WIDTHS)
def test_sga_with_injected_noise_matches_the_unsharded_engine(ranks, unsharded, setup, n):
    """The ranks take their rows of the global draws: the sharded loop is
    the unsharded one, float32 sums aside."""
    got = ranks[n][0]["sga"]
    ref = unsharded.optimize(setup["x"], 0.01, SGA.replace(iterations=ITS),
                             noise_fn=SeededNoise(0, "sga"))
    _assert_rounded_run_close(got, ref)
    np.testing.assert_array_equal(got["z"], ref["z"])
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=METRIC_RTOL)


@pytest.mark.parametrize("n", WIDTHS)
def test_map_early_stop_matches_the_unsharded_engine(ranks, unsharded, setup, n):
    """The reduced probe takes the batch engine's exit."""
    got = ranks[n][0]
    ref = unsharded.optimize(setup["x"], 0.01, MAP.replace(iterations=40))
    assert got["map_early_stop_steps"] == unsharded.last_timing["steps"]
    np.testing.assert_allclose(got["map_early_stop"]["y"], ref["y"], atol=MAP_ATOL)
    np.testing.assert_allclose(got["map_early_stop"]["est_bpp"], ref["est_bpp"],
                               rtol=METRIC_RTOL)


@pytest.mark.parametrize("n", WIDTHS)
def test_halo_exchange_backward_is_its_transpose(ranks, setup, n):
    """float64: the sharded g_s and g_a, and their input gradients through
    the halo exchange's backward, against the unsharded transforms'."""
    y, x, w_x, w_y = (t.clone() for t in setup["grad_inputs"])
    model = build_model(setup["state"], torch.float64)
    y.requires_grad_(True)
    x.requires_grad_(True)
    x_tilde = model.synthesize(y)
    torch.sum(x_tilde * w_x).backward()
    y_a = model.analyze(x)
    torch.sum(y_a * w_y).backward()
    got = ranks[n][0]["grads"]
    for name, ref in (("g_s", x_tilde), ("dy", y.grad), ("g_a", y_a), ("dx", x.grad)):
        ref = ref.detach().numpy()
        err = np.abs(got[name] - ref).max() / np.abs(ref).max()
        assert err <= GRAD_RTOL, (name, err)


@pytest.mark.parametrize("n", WIDTHS)
def test_every_rank_ends_with_the_same_result(ranks, n):
    first = ranks[n][0]
    for other in ranks[n][1:]:
        for case in ("danneal", "sga", "odd"):
            for k, v in first[case].items():
                np.testing.assert_array_equal(other[case][k], v, err_msg=f"{case} {k}")
        assert other["comm_calls"] > 0


def test_msssim_objective_and_bad_sizes_are_refused(setup):
    sp = SpatialLatentOptimizer(build_model(setup["state"]), "cpu")
    with pytest.raises(ValueError, match="MSE objective only"):
        sp.optimize(setup["x"], 10.0, SGA.replace(iterations=1, distortion="msssim"))
    with pytest.raises(ValueError, match="multiples of 64"):
        sp.amortized_init(setup["x_odd"])
