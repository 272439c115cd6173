"""Bitstreams in the port, on the CPU: its own rANS library (built from its
copy of rans.cpp), CDF tables and container, the entropy models' coding
half against nic_tpu's, ``HyperpriorCodec`` round trips, and the CLI's
compress -> decompress.

Tolerances and what is exact:
- rANS, tables and container are copies: byte-identical streams to
  nic_tpu's library on the same symbols, exact round trips;
- PMFs 1e-6 absolute (float32 CDF networks summed in another order); the
  quantized CDFs built from them may differ where a float32 ulp crosses a
  rounding of pmf * 2^16, so the count of differing entries is bounded, not
  zero; cdf and pmf_on_grid 1e-6 absolute, the pdf (a density up to ~1,
  by forward-mode autodiff) 1e-5 relative with a floor of the same
  fraction of its largest value, inverse_cdf 1e-5 absolute;
- symbols and scale indexes of the committed nf = 192 checkpoint on a 64x64
  crop of the photos equal nic_tpu's, and the stream is within 0.5 % of the
  size of nic_tpu's;
- every port stream decodes exactly to the compress side's uint8 pixels.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nic_tpu.coding import CdfTable as JaxCdfTable
from nic_tpu.coding import RansCoder as JaxRansCoder
from nic_tpu.coding.codec import HyperpriorCodec as JaxCodec
from nic_tpu.coding.codec import _encode_pass as jax_encode_pass
from nic_tpu.models.mbt2018 import MeanScaleHyperprior as JaxMBT
from nic_tpu.train.checkpoint import load_params_npz as jax_load_params_npz
from nic_tpu_torch.checkpoint import latest_npz, load_model
from nic_tpu_torch.cli.main import main
from nic_tpu_torch.coding.codec import HyperpriorCodec
from nic_tpu_torch.coding.coder import RansCoder
from nic_tpu_torch.coding.container import PackedBitstream
from nic_tpu_torch.coding.tables import CdfTable, pmf_to_quantized_cdf
from nic_tpu_torch.evaluation.results import rd_results_filename
from nic_tpu_torch.infer.engine import LatentOptimizer
from nic_tpu_torch.infer.methods import SGA

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT_DIR = os.path.join(ROOT, "checkpoints_synth3")
RUN = "mbt2018-num_filters=192-lmbda=0.01"
PHOTOS = os.path.join(ROOT, "data_real", "eval_photos.npy")
PMF_ATOL = 1e-6
# Entries of the quantized z CDFs (192 rows of up to 257) allowed to differ
# from nic_tpu's by one count of 2^-16 where float32 rounding crosses a
# rounding boundary of pmf * 2^16.
MAX_CDF_ENTRIES_DIFFERING = 64
STREAM_SIZE_RTOL = 0.005


@pytest.fixture(scope="module")
def coder():
    return RansCoder()


def make_gaussian_table(scales=(0.5, 1.0, 4.0, 16.0), width=64):
    import scipy.stats

    rows = len(scales)
    length = 2 * width + 1
    pmf = np.zeros((rows, length))
    for i, s in enumerate(scales):
        grid = np.arange(-width, width + 1)
        pmf[i] = (scipy.stats.norm.cdf(grid + 0.5, 0, s)
                  - scipy.stats.norm.cdf(grid - 0.5, 0, s))
    tail = 1.0 - pmf.sum(axis=1)
    return CdfTable.from_pmf(pmf, np.full(rows, -width), np.full(rows, length), tail)


# ------------------------------------------------- rANS, tables, container


def test_quantized_cdf_total_and_monotone():
    pmf = np.array([[0.5, 0.3, 0.2], [0.9, 0.05, 0.05]])
    cdfs, sizes = pmf_to_quantized_cdf(pmf, np.zeros(2), np.array([3, 3]), precision=16)
    assert (sizes == 4).all()
    for r in range(2):
        row = cdfs[r, : sizes[r] + 1]
        assert row[0] == 0 and row[-1] == 1 << 16
        assert (np.diff(row) >= 1).all()


def test_rans_roundtrip(coder, rng):
    table = make_gaussian_table()
    n = 10000
    indexes = rng.integers(0, 4, n).astype(np.int32)
    values = np.round(rng.normal(0, np.array([0.5, 1.0, 4.0, 16.0])[indexes]))
    values = values.astype(np.int32)
    symbols = table.symbols_from_values(values, indexes)
    data = coder.encode(symbols, indexes, table.cdfs, table.cdf_sizes)
    decoded = coder.decode(data, indexes, table.cdfs, table.cdf_sizes)
    np.testing.assert_array_equal(table.values_from_symbols(decoded, indexes), values)
    # The same source as nic_tpu's library: the same bytes.
    assert JaxRansCoder().encode(symbols, indexes, table.cdfs, table.cdf_sizes) == data


@pytest.mark.parametrize("n_per_row", [1, 64], ids=["search", "bucket_index"])
def test_rans_escapes_roundtrip(coder, n_per_row):
    """Values far outside the support round-trip through the escape and
    bypass codes, on both of the decoder's symbol searches."""
    table = make_gaussian_table(width=4)
    values = np.array([-1000, -6, -5, 0, 5, 6, 1000, 123456, -123456], np.int32)
    values = np.tile(values, n_per_row * 4)
    indexes = (np.arange(values.size) % 4).astype(np.int32)
    symbols = table.symbols_from_values(values, indexes)
    data = coder.encode(symbols, indexes, table.cdfs, table.cdf_sizes)
    decoded = coder.decode(data, indexes, table.cdfs, table.cdf_sizes)
    np.testing.assert_array_equal(table.values_from_symbols(decoded, indexes), values)


def test_rans_batch_matches_single(coder, rng):
    table = make_gaussian_table()
    indexes = rng.integers(0, 4, (5, 3000)).astype(np.int32)
    values = np.round(rng.normal(0, np.array([0.5, 1.0, 4.0, 16.0])[indexes]))
    symbols = table.symbols_from_values(values.astype(np.int32), indexes)
    streams = coder.encode_batch(symbols, indexes, table.cdfs, table.cdf_sizes)
    for i, s in enumerate(streams):
        assert s == coder.encode(symbols[i], indexes[i], table.cdfs, table.cdf_sizes)
    decoded = coder.decode_batch(streams, indexes, table.cdfs, table.cdf_sizes)
    np.testing.assert_array_equal(decoded, symbols)


def test_container_pack_unpack():
    p = PackedBitstream()
    p.add_stream("y", b"\x01\x02\x03")
    p.add_ints("x_shape", [768, 512])
    q = PackedBitstream.unpack(p.pack())
    assert q.get_stream("y") == b"\x01\x02\x03" and q.get_ints("x_shape") == [768, 512]
    with pytest.raises(ValueError):
        PackedBitstream.unpack(b"JUNKxxxx")


# ------------------------------------------ the coding half of the models


@pytest.fixture(scope="module")
def models():
    """nic_tpu's and the port's MBT2018 with the committed nf=192 weights."""
    path = latest_npz(os.path.join(CKPT_DIR, RUN))
    _, params = jax_load_params_npz(path)
    _, model = load_model(CKPT_DIR, RUN, 192, "cpu")
    return JaxMBT(num_filters=192), params, model


@pytest.fixture(scope="module")
def crop():
    x = np.load(PHOTOS)[:2, 100:164, 200:264]
    return x.astype(np.float32) / 255.0


def _japply(models, fn, *args):
    jmodel, params, _ = models
    return jmodel.apply({"params": params}, *args, method=fn)


@pytest.mark.parametrize("grid", ["median", "integer"])
def test_pmf_for_coding_matches_nic_tpu(models, grid):
    jpmf, joff, jlen, jtail = (np.asarray(a) for a in _japply(
        models, lambda m: m.pmf_for_coding(grid=grid)))
    pmf, off, length, tail = (t.numpy() for t in models[2].pmf_for_coding(grid=grid))
    np.testing.assert_array_equal(off, joff)
    np.testing.assert_array_equal(length, jlen)
    np.testing.assert_allclose(pmf, jpmf, rtol=0, atol=PMF_ATOL)
    np.testing.assert_allclose(tail, jtail, rtol=0, atol=PMF_ATOL)
    mine = CdfTable.from_pmf(pmf, off, length, tail)
    theirs = JaxCdfTable.from_pmf(jpmf, joff, jlen, jtail)
    np.testing.assert_array_equal(mine.cdf_sizes, theirs.cdf_sizes)
    differing = int(np.sum(mine.cdfs != theirs.cdfs))
    print(f"{grid} grid: {differing} of {mine.cdfs.size} quantized CDF entries "
          "differ from nic_tpu's")
    assert differing <= MAX_CDF_ENTRIES_DIFFERING


def test_gaussian_tables_equal_nic_tpu(models):
    from nic_tpu.models.conditional import GaussianConditional as JaxGC

    for mine, theirs in zip(models[2].conditional.pmfs_for_coding(),
                            JaxGC().pmfs_for_coding()):
        np.testing.assert_array_equal(mine, theirs)


def test_density_functions_match_nic_tpu(models):
    rng = np.random.default_rng(11)
    x = rng.normal(0, 3, (5, 7, 192)).astype(np.float32)
    xi = rng.uniform(0.01, 0.99, (3, 192)).astype(np.float32)
    eb = models[2].entropy_bottleneck
    want_cdf = _japply(models, lambda m, v: m.entropy_bottleneck.cdf(v), jnp.asarray(x))
    want_pdf = _japply(models, lambda m, v: m.entropy_bottleneck.pdf(v), jnp.asarray(x))
    want_inv = _japply(models, lambda m, v: m.entropy_bottleneck.inverse_cdf(v),
                       jnp.asarray(xi))
    want_grid = _japply(models, lambda m: m.entropy_bottleneck.pmf_on_grid(-8.0, 8.0, 0.5))
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(eb.cdf(xt).detach().numpy(), want_cdf, rtol=0, atol=PMF_ATOL)
    np.testing.assert_allclose(eb.pdf(xt).detach().numpy(), want_pdf, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want_pdf).max()))
    np.testing.assert_allclose(eb.inverse_cdf(torch.from_numpy(xi)).numpy(), want_inv,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(eb.pmf_on_grid(-8.0, 8.0, 0.5).numpy(), want_grid,
                               rtol=0, atol=PMF_ATOL)


@pytest.fixture(scope="module")
def codec(models):
    return HyperpriorCodec(models[2], "cpu")


@pytest.fixture(scope="module")
def jax_stream(models, crop):
    jmodel, params, _ = models
    return JaxCodec(jmodel, params).compress(crop)[0]


def test_symbols_indexes_and_stream_size_match_nic_tpu(models, crop, codec, jax_stream):
    jmodel, params, _ = models
    _, jz, jy, jidx = jax_encode_pass(jmodel, params, jnp.asarray(crop))
    blob, out = codec.compress(crop)
    np.testing.assert_array_equal(out["z_symbols"], np.asarray(jz))
    np.testing.assert_array_equal(out["y_symbols"], np.asarray(jy))
    np.testing.assert_array_equal(out["y_indexes"], np.asarray(jidx))
    print(f"stream: port {len(blob)} bytes, nic_tpu {len(jax_stream)} bytes")
    assert abs(len(blob) - len(jax_stream)) <= STREAM_SIZE_RTOL * len(jax_stream)


def test_nic_tpu_stream_in_the_port_is_measured(models, codec, jax_stream, capsys):
    """Whether a nic_tpu-written stream decodes in the port: measured and
    printed, not required (the two may pick other scale indexes or tables)."""
    jmodel, params, _ = models
    want = JaxCodec(jmodel, params).decompress(jax_stream)
    try:
        got = codec.decompress(jax_stream)
        same = float(np.mean(np.round(got * 255) == np.round(want * 255)))
        msg = f"nic_tpu stream decoded in the port: {same:.4%} of pixels equal"
    except ValueError as err:  # a desynchronized stream may fail to decode
        msg = f"nic_tpu stream does not decode in the port: {err}"
    with capsys.disabled():
        print(msg)


@pytest.mark.parametrize("parallel", [False, True], ids=["one_stream", "per_image"])
def test_compress_decompress_exact(codec, crop, parallel):
    blob, out = codec.compress(crop, parallel=parallel)
    x_hat = codec.decompress(blob)
    assert x_hat.shape == crop.shape and x_hat.dtype == np.float32
    np.testing.assert_array_equal(np.round(x_hat * 255.0).astype(np.uint8), out["pixels"])
    np.testing.assert_array_equal(codec.last_pixels, out["pixels"])
    # The pixels are the eval forward's reconstruction, PNG-quantized.
    ref = np.clip(out["x_tilde"].numpy(), 0.0, 1.0)
    assert np.abs(x_hat - ref).max() <= 0.5 / 255.0 + 1e-6
    assert set(codec.last_timing) >= {"device", "rans"}


def test_nonstandard_size_roundtrip(codec):
    x = np.random.default_rng(5).random((1, 75, 90, 3)).astype(np.float32)
    blob, out = codec.compress(x)
    x_hat = codec.decompress(blob)
    assert x_hat.shape == x.shape
    np.testing.assert_array_equal(np.round(x_hat * 255.0).astype(np.uint8), out["pixels"])


def test_actual_bpp_close_to_estimate(codec, crop):
    blob, out = codec.compress(crop)
    num_pixels = crop.shape[0] * crop.shape[1] * crop.shape[2]
    est = float(-(torch.log(out["y_likelihoods"]).sum() + torch.log(
        out["z_likelihoods"]).sum()) / np.log(2.0) / num_pixels)
    actual = len(blob) * 8 / num_pixels
    overhead_bpp = 8 * 150 / num_pixels  # container header
    assert est * 0.9 - 0.01 <= actual <= est * 1.08 + overhead_bpp + 0.02


def test_optimized_latents_roundtrip_exact(models, codec, crop):
    res = LatentOptimizer(models[2], "cpu").optimize(
        crop, 0.01, method=SGA.replace(iterations=3))
    blob = codec.compress_optimized(res["y"], res["z"], crop.shape[1:3])
    pixels = codec.last_pixels
    x_hat = codec.decompress(blob)  # dispatches on the stream's mode
    np.testing.assert_array_equal(np.round(x_hat * 255.0).astype(np.uint8), pixels)
    np.testing.assert_array_equal(codec.decompress_optimized(blob), x_hat)
    ref = np.clip(res["x_tilde"], 0.0, 1.0)
    assert np.abs(x_hat - ref).max() <= 0.5 / 255.0 + 1e-6
    with pytest.raises(ValueError, match="mode"):
        codec.decompress_optimized(codec.compress(crop)[0])


def test_compress_latents_roundtrip(codec, crop):
    """The amortized transmitted pair through compress_latents decodes with
    plain decompress to the same pixels as compress's own stream."""
    _, out = codec.compress(crop)
    blob = codec.compress_latents(out["y_tilde"].numpy(), out["z_tilde"].numpy(),
                                  crop.shape[1:3])
    x_hat = codec.decompress(blob)
    np.testing.assert_array_equal(np.round(x_hat * 255.0).astype(np.uint8), out["pixels"])


# ------------------------------------------------------------------- CLI


@pytest.fixture(scope="module")
def crop_file(tmp_path_factory, crop):
    d = tmp_path_factory.mktemp("codec_cli")
    np.save(d / "crop.npy", np.round(crop[:1] * 255).astype(np.uint8))
    return d


def _png(path):
    return np.asarray(Image.open(path).convert("RGB"))


def test_cli_mbt2018_compress_decompress(crop_file):
    d = crop_file
    common = ["--device", "cpu", "--num_filters", "192", "--checkpoint_dir", CKPT_DIR,
              "mbt2018"]
    out = main(common + ["compress", "--results_dir", str(d / "res"), RUN,
                         str(d / "crop.npy"), str(d / "crop.ntc")])
    rd = np.load(d / "res" / rd_results_filename("mbt2018", RUN, "crop.npy"))
    assert {"batch_actual_bpp", "avg_batch_actual_bpp", "batch_sizes", "est_bpp"} <= set(rd.files)
    assert float(rd["avg_batch_actual_bpp"]) == pytest.approx(
        os.path.getsize(d / "crop.ntc") * 8 / (64 * 64))
    dec = main(common + ["decompress", RUN, str(d / "crop.ntc"), str(d / "crop.png")])
    np.testing.assert_array_equal(_png(d / "crop.png"), out["pixels"][0])
    assert dec["path"] == str(d / "crop.png")


def test_cli_sga_compress_to_a_stream_and_decompress(crop_file):
    d = crop_file
    common = ["--device", "cpu", "--num_filters", "192", "--checkpoint_dir", CKPT_DIR, "sga"]
    out = main(common + ["compress", "--results_dir", str(d / "res_sga"), "--sga_its", "2",
                         "--save_reconstruction", RUN, str(d / "crop.npy"),
                         str(d / "sga.ntc")])
    assert os.path.getsize(d / "sga.ntc") == out["bytes"]
    main(common + ["decompress", RUN, str(d / "sga.ntc")])
    np.testing.assert_array_equal(_png(str(d / "sga.ntc") + ".png"), out["pixels"][0])
    recon = [f for f in os.listdir(d / "res_sga") if f.startswith("recon-sga-")]
    assert len(recon) == 1


def test_compress_optimized_stream_size_matches_nic_tpu(models, crop, codec):
    """The same plainly rounded latents through nic_tpu's and the port's
    compress_optimized: stream sizes within 0.5 %, as for compress."""
    jmodel, params, model = models
    res = LatentOptimizer(model, "cpu").optimize(crop, 0.01, method=SGA.replace(iterations=3))
    blob = codec.compress_optimized(res["y"], res["z"], crop.shape[1:3])
    jax_blob = JaxCodec(jmodel, params).compress_optimized(res["y"], res["z"],
                                                           crop.shape[1:3])
    print(f"optimized stream: port {len(blob)} bytes, nic_tpu {len(jax_blob)} bytes")
    assert abs(len(blob) - len(jax_blob)) <= STREAM_SIZE_RTOL * len(jax_blob)
