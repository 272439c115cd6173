"""The port's int8 W8A8 convolutions (``ops/int8conv.py``) and ``--quant``
against nic_tpu's ``ops/int8conv.py``, on the CPU.

Bit for bit, in float32 and bfloat16: the quantizers (int8 values and
scales), ``int8_conv``'s int32 sums and bfloat16 outputs (transposed 5x5/2,
strided 5x5/2, 3x3/1 and transposed 3x3/2, at odd and even sizes, with
channel counts that are not multiples of 8), ``int8_conv_transpose_qbwd``'s
int8 input cotangent, and a quantized ``SignalConv``'s forward. Then, with
the tolerances stated:
- the straight-through backward (dx and dw, against ``_int8_conv_bwd``):
  float32 1e-5, bfloat16 2e-3, both max-norm relative (the bf16 tolerance
  of tests/test_torch_bf16.py: XLA's bf16 conv and torch's round their
  float32 sums in another order);
- ``MeanScaleHyperprior(nf=8, bf16, quant="int8")`` fed nic_tpu's own
  rounded latents, against nic_tpu with its Pallas GDN (K1's semantics):
  mu, sigma and both likelihoods 1e-5 elementwise, x_tilde 1.6e-2 max-norm
  relative (four bf16 ulps), as tests/test_torch_bf16.py holds the bf16
  model; and the whole forward, its rounded latents at most 0.5 % apart;
- 20 SGA steps at int8 and int8_all (float32 transforms, the CLI's; JAX's
  Gumbel draws injected): every loss within 1e-3, as the bf16 SGA steps of
  tests/test_torch_bf16.py;
- the CLI: ``mbt2018`` and ``sga compress --quant`` streams decode exactly
  under the same ``--quant``; ``mbt2018 compress --quant int8``'s rates
  against nic_tpu's CLI at the fp32 CLI tolerance, 1e-5, and its MSE and
  PSNR at 1e-4: a float32 ulp of an IGDN output (sums in another order) can
  move the next int8 layer's rounding of that element by one step, 1/127 of
  the layer's scale, and so an 8-bit pixel (measured 2.7e-5);
  ``--data_parallel --quant int8`` on 2 gloo ranks equal to one rank (the
  activation scales reduced over the ranks); ``--spatial --quant int8``'s
  first step against nic_tpu's ``SpatialLatentOptimizer`` on the quant
  model at 1e-3 (tests/test_torch_spatial.py's tolerance), its sharded g_s
  the float one. These two run a "loud" model (g_a's last kernel 30x):
  with nic_tpu's initial weights y rounds to zeros on a flat image, and a
  per-rank or per-shard scale would give the same result there, so the
  tests could not tell it from the right one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from jax import lax

from nic_tpu.cli.main import main as jax_main
from nic_tpu.infer.engine import LatentOptimizer as JaxLatentOptimizer
from nic_tpu.infer.methods import DANNEAL as JAX_DANNEAL
from nic_tpu.infer.methods import SGA as JAX_SGA
from nic_tpu.models.layers import SignalConv as JaxSignalConv
from nic_tpu.models.mbt2018 import MeanScaleHyperprior as JaxMBT
from nic_tpu.ops import int8conv as jax_int8
from nic_tpu.parallel.mesh import data_mesh
from nic_tpu.parallel.spatial import SpatialLatentOptimizer as JaxSpatial
from nic_tpu_torch.checkpoint import params_from_jax
from nic_tpu_torch.cli.main import main
from nic_tpu_torch.coding.codec import HyperpriorCodec
from nic_tpu_torch.evaluation.results import rd_results_filename
from nic_tpu_torch.infer.engine import LatentOptimizer
from nic_tpu_torch.infer.methods import SGA
from nic_tpu_torch.models.layers import SignalConv
from nic_tpu_torch.models.mbt2018 import MeanScaleHyperprior
from nic_tpu_torch.ops import int8conv
from nic_tpu_torch.parallel.mesh import spawn

from test_torch_engine import jax_gumbel_fn
from torch_dist_workers import spatial_int8_cases

torch.set_num_threads(1)

DN = ("NHWC", "HWIO", "NHWC")
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (kernel, stride, transpose, x shape, output channels)
SHAPES = [
    (5, 2, True, (2, 6, 8, 16), 24),
    (5, 2, True, (1, 3, 5, 12), 20),
    (5, 2, False, (2, 13, 9, 16), 12),
    (3, 1, False, (2, 7, 8, 16), 24),
    (3, 2, True, (2, 5, 6, 12), 16),
]
GRAD_RTOL = {"float32": 1e-5, "bfloat16": 2e-3}
EXACT_RTOL = 1e-5
X_TILDE_RTOL = 1.6e-2
MAX_ROUNDINGS_FLIPPED = 0.005
SGA_RTOL = 1e-3
CLI_RTOL = 1e-5
CLI_DISTORTION_RTOL = 1e-4
SPATIAL_RTOL = 1e-3
NF = 8
RUN = "mbt2018-num_filters=8-lmbda=0.01"
FIELDS = ("mse", "psnr", "msssim", "msssim_db", "est_bpp", "est_y_bpp", "est_z_bpp")


def max_rel(actual, expected):
    actual = np.asarray(actual, np.float64)
    expected = np.asarray(expected, np.float64)
    return float(np.abs(actual - expected).max() / np.abs(expected).max())


def assert_rel(actual, expected, rtol):
    actual = np.asarray(actual, np.float64)
    expected = np.asarray(expected, np.float64)
    floor = rtol * max(float(np.nanmax(np.abs(expected), initial=0.0)), 1e-30)
    np.testing.assert_allclose(actual, expected, rtol=rtol, atol=floor)


def as_f64(a):
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def assert_bits(actual, expected):
    np.testing.assert_array_equal(as_f64(actual), as_f64(expected))


def conv_inputs(dtype, shape, k, co, seed=0):
    """x, w (HWIO) and a cotangent for the output, as (jax, torch) pairs."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, shape).astype(np.float32)
    w = rng.normal(0, 0.1, (k, k, shape[3], co)).astype(np.float32)
    return ((jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)),
            (jnp.asarray(w).astype(jdt), torch.from_numpy(w).to(tdt)))


def jax_int32(q, wq, stride, transpose):
    if transpose:
        return lax.conv_transpose(q, wq, (stride, stride), "SAME", dimension_numbers=DN,
                                  preferred_element_type=jnp.int32)
    return lax.conv_general_dilated(q, wq, (stride, stride), "SAME", dimension_numbers=DN,
                                    preferred_element_type=jnp.int32)


# ------------------------------------------------------------------ the op


@pytest.mark.parametrize("dtype", DTYPES)
def test_quantizers_bit_equal(dtype):
    (xj, xt), (wj, wt) = conv_inputs(dtype, (2, 6, 7, 12), 5, 20)
    for (qj, sj), (qt, st) in (
        (jax_int8._quantize_per_tensor(xj), int8conv.quantize_per_tensor(xt)),
        (jax_int8._quantize_weight_per_cout(wj), int8conv.quantize_weight_per_cout(wt)),
    ):
        assert qt.dtype == torch.int8 and st.dtype == xt.dtype
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        assert_bits(st, sj)
    # A zero tensor quantizes to zeros with the 1e-12 floor's scale.
    qz, sz = int8conv.quantize_per_tensor(torch.zeros(3, dtype=xt.dtype))
    assert not qz.any() and float(sz) > 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,stride,transpose,shape,co", SHAPES)
def test_int8_conv_forward_bit_equal(dtype, k, stride, transpose, shape, co):
    """The int32 sums of the quantized operands and the bf16 outputs."""
    (xj, xt), (wj, wt) = conv_inputs(dtype, shape, k, co)
    qj, _ = jax_int8._quantize_per_tensor(xj)
    wqj, _ = jax_int8._quantize_weight_per_cout(wj)
    qt, _ = int8conv.quantize_per_tensor(xt)
    wqt, _ = int8conv.quantize_weight_per_cout(wt)
    acc = int8conv.conv_int32(qt, wqt, stride, transpose)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jax_int32(qj, wqj, stride, transpose)))
    got = int8conv.int8_conv(xt, wt, stride, transpose)
    assert got.dtype == torch.bfloat16
    assert_bits(got, jax_int8.int8_conv(xj, wj, stride, transpose))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,stride,transpose,shape,co", SHAPES)
def test_ste_backward_matches_nic_tpu(dtype, k, stride, transpose, shape, co):
    """dx and dw: the gradient of the conv in x's dtype with the original
    weights, at a random cotangent."""
    (xj, xt), (wj, wt) = conv_inputs(dtype, shape, k, co)
    yj, vjp = jax.vjp(lambda a, b: jax_int8.int8_conv(a, b, stride, transpose), xj, wj)
    g = np.random.default_rng(1).normal(0, 1, yj.shape).astype(np.float32)
    dxj, dwj = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    xt.requires_grad_(True)
    wt.requires_grad_(True)
    yt = int8conv.int8_conv(xt, wt, stride, transpose)
    dxt, dwt = torch.autograd.grad(yt, (xt, wt), torch.from_numpy(g).to(torch.bfloat16))
    assert dxt.dtype == xt.dtype and dwt.dtype == wt.dtype
    for got, want in ((dxt, dxj), (dwt, dwj)):
        if dtype == "float32":
            assert_rel(as_f64(got), as_f64(want), GRAD_RTOL[dtype])
        else:
            assert max_rel(as_f64(got), as_f64(want)) <= GRAD_RTOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_qbwd_input_cotangent_bit_equal(dtype):
    """int8_conv_transpose_qbwd: the forward is int8_conv's, dx is the int8
    stride-2 conv of the quantized cotangent (``_qbwd_x_up2``) bit for bit,
    dw the float one; a weight that needs no gradient gets none."""
    (xj, xt), (wj, wt) = conv_inputs(dtype, (2, 5, 7, 16), 5, 12)
    yj, vjp = jax.vjp(lambda a, b: jax_int8.int8_conv_transpose_qbwd(a, b, 2), xj, wj)
    g = jnp.asarray(np.random.default_rng(2).normal(0, 1, yj.shape), jnp.bfloat16)
    dxj, dwj = vjp(g)
    gt = torch.tensor(np.asarray(g.astype(jnp.float32))).to(torch.bfloat16)
    assert_bits(int8conv.qbwd_x_up2(gt, wt, 2), jax_int8._qbwd_x_up2(g, wj, 2))
    xt.requires_grad_(True)
    wt.requires_grad_(True)
    yt = int8conv.int8_conv_transpose_qbwd(xt, wt, 2)
    assert_bits(yt, yj)
    dxt, dwt = torch.autograd.grad(yt, (xt, wt), gt)
    assert_bits(dxt, dxj)
    if dtype == "float32":
        assert_rel(as_f64(dwt), as_f64(dwj), GRAD_RTOL[dtype])
    else:
        assert max_rel(as_f64(dwt), as_f64(dwj)) <= GRAD_RTOL[dtype]
    (dx_only,) = torch.autograd.grad(
        int8conv.int8_conv_transpose_qbwd(xt, wt.detach(), 2), xt, gt)
    assert_bits(dx_only, dxj)


def test_reduce_max_sets_the_scale():
    """``reduce_max`` replaces max|x| (a rank's part of a batch quantizes
    with the whole batch's scale)."""
    x = torch.tensor([0.5, -1.0, 0.25])
    q, s = int8conv.quantize_per_tensor(x, lambda amax: amax * 2)
    assert float(s) == pytest.approx(2.0 / 127) and q.tolist() == [32, -64, 16]


@pytest.mark.parametrize("quant", ["int8", "int8_all"])
@pytest.mark.parametrize("kernel,down,up,h,w", [(5, 1, 2, 5, 7), (5, 2, 1, 9, 8),
                                                (3, 1, 1, 6, 5)])
def test_signal_conv_quant_matches_flax(quant, kernel, down, up, h, w):
    """A quantized SignalConv (float32 layer): the int8 output cast back to
    float32 plus the bias, bit for bit; dx at the float32 tolerance."""
    cin, cout = 6, 10
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, h, w, cin)).astype(np.float32)
    layer = JaxSignalConv(cout, (kernel, kernel), strides_down=down, strides_up=up,
                          quant=quant)
    params = dict(layer.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    params["bias"] = jnp.asarray(rng.normal(0, 0.1, (cout,)).astype(np.float32))
    out_hw = (h * up, w * up) if up > 1 else (-(-h // down), -(-w // down))
    g = rng.normal(0, 1, (2, *out_hw, cout)).astype(np.float32)
    ref, vjp = jax.vjp(lambda a: layer.apply({"params": params}, a), jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(g))
    conv = SignalConv(cin, cout, kernel, strides_down=down, strides_up=up, quant=quant)
    with torch.no_grad():
        conv.weight.copy_(conv.weight_from_hwio(np.asarray(params["kernel"])))
        conv.bias.copy_(torch.from_numpy(np.asarray(params["bias"])))
    conv.requires_grad_(False)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = conv(xt)
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    assert out.dtype == torch.float32
    assert_bits(out, ref)
    assert_rel(as_f64(dx), as_f64(ref_dx), GRAD_RTOL["float32"])


# ---------------------------------------------------------------- the model


@pytest.fixture(scope="module")
def nf8():
    """nic_tpu's nf=8 initial parameters, their port state, two photo crops."""
    import os

    params = JaxMBT(num_filters=NF).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), training=True,
        rng=jax.random.PRNGKey(1))["params"]
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    photos = np.load(os.path.join(root, "data_real", "eval_photos.npy"))
    x = photos[:2, 100:164, 200:264].astype(np.float32) / 255.0
    # The same with g_a's last kernel 30x ("loud"): at the initial scale y
    # rounds to zeros on a flat image, where every int8 scale gives the same.
    loud = dict(flat)
    loud["analysis/layer_3/kernel"] = 30.0 * flat["analysis/layer_3/kernel"]
    loud_params = traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in loud.items()})
    return dict(params=params, flat=flat, state=params_from_jax(flat), x=x, loud=loud,
                loud_params=loud_params, loud_state=params_from_jax(loud))


def port_model(state, dtype=torch.float32, quant=None):
    model = MeanScaleHyperprior(NF, dtype)
    model.load_state_dict(state)
    return model.clone(quant=quant) if quant else model


def test_clone_shares_parameters_and_sets_quant(nf8):
    base = port_model(nf8["state"])
    q = base.clone(quant="int8_all")
    assert all(a is b for a, b in zip(base.parameters(), q.parameters()))
    assert q.entropy_bottleneck.quantile_targets is base.entropy_bottleneck.quantile_targets
    quantized = {n for n, m in q.named_modules()
                 if isinstance(m, SignalConv) and m.quant == "int8_all"}
    assert quantized == {"synthesis.layer_0", "synthesis.layer_1", "synthesis.layer_2",
                         "hyper_synthesis.layer_0", "hyper_synthesis.layer_1"}
    assert base.synthesis.layer_0.quant is None and q.compute_dtype == base.compute_dtype


def test_quant_model_forward_matches_nic_tpu(nf8):
    """bf16 transforms with quant="int8": fed nic_tpu's own rounded latents
    (so that every int8 layer sees the same input), and the whole eval
    forward."""
    jm = JaxMBT(num_filters=NF, compute_dtype=jnp.bfloat16, quant="int8", use_pallas_gdn=True)
    v = {"params": nf8["params"]}
    x = nf8["x"]
    ref = jm.apply(v, jnp.asarray(x), training=False)
    model = port_model(nf8["state"], torch.bfloat16, "int8").eval()
    z_tilde = torch.from_numpy(np.asarray(ref["z_tilde"]))
    y_tilde = torch.from_numpy(np.asarray(ref["y_tilde"]))
    with torch.no_grad():
        mu, sigma = model.hyper_synthesize(z_tilde, tuple(y_tilde.shape[1:3]))
        y_lik = model.y_likelihood(y_tilde, mu, sigma)
        x_tilde = model.synthesize(y_tilde, x.shape[1:3])
        out = model(torch.from_numpy(x))
    assert_rel(mu, ref["mu"], EXACT_RTOL)
    assert_rel(sigma, ref["sigma"], EXACT_RTOL)
    assert_rel(y_lik, ref["y_likelihoods"], EXACT_RTOL)
    assert max_rel(x_tilde, ref["x_tilde"]) <= X_TILDE_RTOL
    for k in ("y_tilde", "z_tilde"):
        assert np.mean(out[k].numpy() != np.asarray(ref[k])) <= MAX_ROUNDINGS_FLIPPED, k
    assert np.isfinite(out["x_tilde"].numpy()).all()


@pytest.mark.parametrize("quant", ["int8", "int8_all"])
def test_sga_steps_match_nic_tpu(nf8, quant):
    steps = 20
    ref = JaxLatentOptimizer(JaxMBT(num_filters=NF, quant=quant), nf8["params"]).optimize(
        nf8["x"], 0.01, method=JAX_SGA.replace(iterations=steps), seed=0)
    out = LatentOptimizer(port_model(nf8["state"], quant=quant), "cpu").optimize(
        nf8["x"], 0.01, method=SGA.replace(iterations=steps), seed=0,
        noise_fn=jax_gumbel_fn(0, steps))
    assert_rel(out["losses"], ref["losses"], SGA_RTOL)
    for k in ("mse", "est_bpp"):
        assert_rel(out[k], ref[k], SGA_RTOL)


def test_int8_scale_is_the_whole_batch_s(nf8):
    """Why the codec and the data-parallel ranks must quantize over the
    whole batch: h_s of one image alone gives another mu than the same
    image within the batch."""
    model = port_model(nf8["state"], quant="int8").eval()
    with torch.no_grad():
        z = model.hyper_analyze(model.analyze(torch.from_numpy(nf8["x"])))
        z = z * torch.tensor([1.0, 3.0]).view(2, 1, 1, 1)  # image 1 sets the scale
        mu_batch, _ = model.hyper_synthesize(z)
        mu_alone, _ = model.hyper_synthesize(z[:1])
    assert not torch.equal(mu_batch[:1], mu_alone)


# -------------------------------------------------------------- the CLI


@pytest.fixture(scope="module")
def workdir(tmp_path_factory, nf8):
    d = tmp_path_factory.mktemp("int8_cli")
    run_dir = d / "ckpt" / RUN
    run_dir.mkdir(parents=True)
    np.savez(run_dir / "params-0.npz", **nf8["flat"])
    crops = np.round(nf8["x"] * 255.0).astype(np.uint8)
    np.save(d / "crops.npy", crops)
    return d


def _argv(workdir, script, command, *args, ckpt="ckpt"):
    return ["--num_filters", str(NF), "--checkpoint_dir", str(workdir / ckpt), script,
            command, RUN, *map(str, args)]


@pytest.mark.parametrize("script,quant", [("mbt2018", "int8"), ("mbt2018", "int8_all"),
                                          ("sga", "int8"), ("sga", "int8_all")])
def test_quant_streams_decode_exactly(workdir, script, quant):
    """compress --quant -> decompress --quant, the 2-crop batch in one
    stream: the decoder's h_s runs on the whole batch, as the encoder's."""
    stream, png = workdir / f"{script}_{quant}.ntc", workdir / f"{script}_{quant}.png"
    out = main(["--device", "cpu"] + _argv(
        workdir, script, "compress", workdir / "crops.npy", stream, "--quant", quant,
        "--sga_its", "3", "--results_dir", workdir / f"res_{script}_{quant}"))
    dec = main(["--device", "cpu"] + _argv(workdir, script, "decompress", stream, png,
                                           "--quant", quant))
    assert dec["x_hat"].shape[0] == 2
    np.testing.assert_array_equal(np.round(dec["x_hat"] * 255.0).astype(np.uint8),
                                  out["pixels"])


def test_mbt2018_quant_compress_matches_jax_cli(workdir):
    for cli, before, res in ((jax_main, [], "res_jax_q"), (main, ["--device", "cpu"], "res_q")):
        cli(before + _argv(workdir, "mbt2018", "compress", workdir / "crops.npy",
                           workdir / f"{res}.ntc", "--quant", "int8", "--results_dir",
                           workdir / res))
    name = rd_results_filename("mbt2018", RUN, "crops.npy", None)
    ref, got = np.load(workdir / "res_jax_q" / name), np.load(workdir / "res_q" / name)
    for k in ("est_bpp", "est_y_bpp", "est_z_bpp", "avg_batch_actual_bpp"):
        assert_rel(got[k], ref[k], CLI_RTOL)
    for k in ("mse", "psnr"):
        assert_rel(got[k], ref[k], CLI_DISTORTION_RTOL)


def test_data_parallel_quant_matches_one_rank(workdir, nf8, monkeypatch):
    """sga --data_parallel --quant int8 on 2 gloo ranks, one image each: the
    one-rank run's results and stream, since every per-tensor scale is the
    whole batch's (test_int8_scale_is_the_whole_batch_s). On the loud
    model, the first image flat grey and the second noise: the first one's
    own scales would be far finer than the batch's."""
    run_dir = workdir / "ckpt_dp" / RUN
    run_dir.mkdir(parents=True)
    np.savez(run_dir / "params-0.npz", **nf8["loud"])
    crops = np.full((2, 64, 64, 3), 128, np.uint8)
    crops[1] = np.random.default_rng(4).integers(0, 256, (64, 64, 3), np.uint8)
    np.save(workdir / "dp_crops.npy", crops)
    common = ("--quant", "int8", "--sga_its", "3")
    ref = main(["--device", "cpu"] + _argv(
        workdir, "sga", "compress", workdir / "dp_crops.npy", workdir / "one.ntc", *common,
        "--results_dir", workdir / "res_one", ckpt="ckpt_dp"))
    monkeypatch.setenv("NIC_TPU_TORCH_CPU_RANKS", "2")
    out = main(["--device", "cpu"] + _argv(
        workdir, "sga", "compress", workdir / "dp_crops.npy", workdir / "dp.ntc", *common,
        "--data_parallel", "--results_dir", workdir / "res_dp", ckpt="ckpt_dp"))
    assert (workdir / "dp.ntc").read_bytes() == (workdir / "one.ntc").read_bytes()
    for k in FIELDS:
        np.testing.assert_allclose(out["results"][k], ref["results"][k], rtol=1e-6,
                                   err_msg=k)


def test_codec_quant_round_trip_and_batch(nf8):
    """The codec under int8: the 2-image stream decodes to the encoder's
    pixels, and the decoder's mu is the whole batch's h_s."""
    model = port_model(nf8["state"], quant="int8")
    codec = HyperpriorCodec(model, "cpu")
    blob, out = codec.compress(nf8["x"])
    x_hat = codec.decompress(blob)
    np.testing.assert_array_equal(np.round(x_hat * 255.0).astype(np.uint8), out["pixels"])


def test_spatial_quant_first_step_matches_nic_tpu(nf8):
    """--spatial on 2 gloo ranks with the int8 loud model: h_s int8 on each
    rank's whole z, g_s's row shards in float, as nic_tpu's spatial path:
    danneal's first step and its transmitted latents' metrics; and the
    sharded g_s of the int8 model is the float model's."""
    x = np.random.default_rng(0).random((1, 128, 64, 3), np.float32)
    jax_model = JaxMBT(num_filters=NF, quant="int8")
    sp = JaxSpatial(jax_model, nf8["loud_params"], mesh=data_mesh(2))
    ref = sp.optimize(x, 0.01, method=JAX_DANNEAL.replace(iterations=1))
    ranks = spawn(spatial_int8_cases, 2, (nf8["loud_state"], x, 1), device="cpu")
    got = ranks[0]
    assert_rel(got["losses"], ref["losses"], SPATIAL_RTOL)
    for k in ("est_bpp", "psnr"):
        assert_rel(got[k], ref[k], SPATIAL_RTOL)
    assert np.mean(got["y"] == np.asarray(ref["y"])) >= 1 - MAX_ROUNDINGS_FLIPPED
    np.testing.assert_array_equal(got["g_s_int8_model"], got["g_s_float_model"])
    assert not np.array_equal(got["g_s_int8_model"], got["g_s_unsharded_int8"])
