"""BB-ANS bitstreams in the port (``coding/bb_codec.py``) against nic_tpu's,
on the CPU: the prior, posterior and Laplacian tables, the trimmed initial
bits, the bytes written, the round trips (chained, unchained, optimized)
and the integrity check.

What is exact and what is bounded:
- the posterior tables (host float64 from the same arrays), the Laplacian
  delta tables and the seeded stack are nic_tpu's code: equal;
- the prior's table comes from a float32 CDF network summed in another
  order, so a few quantized frequencies may differ by one count of 2^-16
  where an ulp crosses a rounding of pmf * 2^16 (8 of 61440 measured on
  the committed checkpoint): at most MAX_FREQS_DIFFERING;
- fed nic_tpu's posterior and prior table, the port writes nic_tpu's bytes;
- from the port's own posterior, which differs from nic_tpu's by float32
  ulps, the first q-table entry that differs sends the posterior pop (a
  draw from the stack's bits) down another path, so the stream is another
  sample of the same distribution: its size is a random variable (one
  standard deviation 2.4 % over seeds for the three 384x512 photos, 6.5 %
  for two 64x64 crops). The mean size over SEEDS seeds is held against
  nic_tpu's within SIZE_MEAN_RTOL;
- every port stream decodes exactly to the encoder's pixels, with its
  initial bits back.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nic_tpu.coding.bb_codec import BitsBackCodec as JaxCodec
from nic_tpu.models.mbt2018_bb import BitsBackHyperprior as JaxBB
from nic_tpu.train.checkpoint import load_params_npz as jax_load_params_npz
from nic_tpu_torch.checkpoint import latest_npz, load_model
from nic_tpu_torch.coding.bb_codec import BitsBackCodec
from nic_tpu_torch.coding.container import PackedBitstream

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT_DIR = os.path.join(ROOT, "checkpoints_synth3")
RUN = "mbt2018_bb-num_filters=192-lmbda=0.01"
PHOTOS = os.path.join(ROOT, "data_real", "eval_photos.npy")
MAX_FREQS_DIFFERING = 64
SEEDS = 16
# Two 64x64 crops: a single stream's size has a standard deviation of 6.5 %
# over seeds (both sides), so the difference of two means of 16 has one of
# 2.3 %; 6 % is 2.6 of those. Measured over 8 seeds: 0.1 % (plain) and
# 0.5 % (optimized).
SIZE_MEAN_RTOL = 0.06


@pytest.fixture(scope="module")
def codecs():
    """nic_tpu's and the port's codec on the committed nf=192 checkpoint."""
    _, params = jax_load_params_npz(latest_npz(os.path.join(CKPT_DIR, RUN)))
    _, model = load_model(CKPT_DIR, RUN, 192, "cpu", model="mbt2018_bb")
    return JaxCodec(JaxBB(num_filters=192), params), BitsBackCodec(model, "cpu")


@pytest.fixture(scope="module")
def crops():
    return np.load(PHOTOS)[:2, 100:164, 200:264].astype(np.float32) / 255.0


def jax_posterior(jc, y_star):
    zm, zl = jc.model.apply({"params": jc.params}, jnp.asarray(y_star),
                            method=jc.model.hyper_posterior)
    return np.asarray(zm), np.asarray(zl)


def port_y_star(codec, x):
    with torch.no_grad():
        return torch.round(codec.model.analyze(torch.tensor(x))).numpy()


def optimized_posterior(codec, y_star, shift_mean=0.3, shift_logvar=-0.5):
    """A posterior away from the amortized one, so the deltas are not zero."""
    with torch.no_grad():
        zm, zl = (t.numpy() for t in codec.model.hyper_posterior(torch.tensor(y_star)))
    noise = np.random.default_rng(9).standard_normal(zm.shape)
    return (zm + shift_mean * noise).astype(np.float32), (zl + shift_logvar).astype(np.float32)


# ----------------------------------------------------------------- tables


def test_prior_table_matches_nic_tpu(codecs):
    jc, c = codecs
    ref, got = jc.p_table(), c.p_table()
    assert got[0].shape == ref[0].shape == (192, c.num_bins + 1)
    np.testing.assert_array_equal(got[1], ref[1])
    freqs = [np.diff(t.astype(np.int64), axis=1) for t in (got[0], ref[0])]
    assert np.abs(freqs[0] - freqs[1]).max() <= 1
    assert np.sum(freqs[0] != freqs[1]) <= MAX_FREQS_DIFFERING


def test_posterior_laplace_tables_and_seeding_equal_nic_tpus(codecs, crops):
    jc, c = codecs
    zm, zl = jax_posterior(jc, port_y_star(c, crops[:1]))
    ref, got = jc.q_tables(zm, zl), c.q_tables(zm, zl)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    for scale in (1, 37, 256, 5000):
        for a, b in zip(c._laplace_table(scale), jc._laplace_table(scale)):
            np.testing.assert_array_equal(a, b)
    rows = np.arange(zm.size, dtype=np.int32)
    ref_stack, *ref_rest = jc._seeded_stack(5, zm.size, rows, *ref)
    stack, *rest = c._seeded_stack(5, zm.size, rows, *got)
    np.testing.assert_array_equal(rest[0], ref_rest[0])
    assert rest[1:] == ref_rest[1:] and rest[1] < rest[2]
    assert stack.serialize() == ref_stack.serialize()
    assert c._expected_initial(5, rest[2], rest[1]) == jc._expected_initial(5, rest[2],
                                                                            rest[1])


# ------------------------------------------------------------------ bytes


def test_bytes_equal_nic_tpus_on_its_posterior(codecs, crops):
    """The coding half alone: given nic_tpu's y*, posterior and prior table
    (whose few differing frequencies would change the bits the chain pushes
    for the next image to pop), the port pops the same bins, codes the same
    y symbols and writes nic_tpu's stream, plain and optimized."""
    jc, _ = codecs
    _, model = load_model(CKPT_DIR, RUN, 192, "cpu", model="mbt2018_bb")
    c = BitsBackCodec(model, "cpu")
    c._p_table = jc.p_table()
    y_star = port_y_star(c, crops)
    zm, zl = jax_posterior(jc, y_star)
    ref, _ = jc.compress(crops, seed=3)
    streams = c._encode(c._canonical(y_star), zm, zl, 3, True)
    assert c._pack((64, 64), y_star, zm.shape[1:3], 3, *streams, True) == ref

    zm_opt, zl_opt = optimized_posterior(c, y_star)
    ref, _ = jc.compress_optimized(crops, y_star, zm_opt, zl_opt, seed=4)
    dm, dl, zm_hat, zl_hat = c._quantize_posterior(zm_opt, zl_opt, zm, zl)
    scales = [max(1, int(round(np.mean(np.abs(d)) * 256))) for d in (dm, dl)]
    rows = np.zeros(dm.size, np.int32)
    deltas = [c.coder.encode(d.reshape(-1) + c.DELTA_CLIP, rows, *c._laplace_table(s))
              for d, s in zip((dm, dl), scales)]
    streams = c._encode(c._canonical(y_star), zm_hat, zl_hat, 4, True)
    blob = c._pack((64, 64), y_star, zm.shape[1:3], 4, *streams, True,
                   (*deltas, scales))
    assert blob == ref


@pytest.mark.parametrize("optimized", [False, True])
def test_mean_stream_size_near_nic_tpus(codecs, crops, optimized):
    """End to end, from each side's own posterior: the mean size over
    SEEDS seeds within SIZE_MEAN_RTOL of nic_tpu's."""
    jc, c = codecs
    y_star = port_y_star(c, crops)
    zm_opt, zl_opt = optimized_posterior(c, y_star)

    def size(codec, seed):
        if optimized:
            return len(codec.compress_optimized(crops, y_star, zm_opt, zl_opt, seed=seed)[0])
        return len(codec.compress(crops, seed=seed)[0])

    ref = np.mean([size(jc, s) for s in range(SEEDS)])
    got = np.mean([size(c, s) for s in range(SEEDS)])
    assert abs(got - ref) <= SIZE_MEAN_RTOL * ref


# ------------------------------------------------------------ round trips


def _pixels(x_hat):
    return np.round(x_hat * 255.0).astype(np.uint8)


@pytest.mark.parametrize("chained", [True, False])
def test_roundtrip_exact_with_the_initial_bits_back(codecs, crops, chained):
    _, c = codecs
    blob, info = c.compress(crops, seed=5, chained=chained)
    pixels = c.last_pixels
    x_hat, init_ok = c.decompress(blob)
    assert init_ok, "the decoder must return the encoder's initial bits exactly"
    np.testing.assert_array_equal(_pixels(x_hat), pixels)
    assert PackedBitstream.unpack(blob).get_ints("chained") == [int(chained)]
    assert 0 < info["net_bpp"] < info["actual_bpp"]
    # The reconstruction is g_s(round(g_a(x))), clipped and 8-bit rounded.
    with torch.no_grad():
        direct = c.model.synthesize(torch.round(c.model.analyze(torch.tensor(crops))),
                                    (64, 64)).clamp(0.0, 1.0).numpy()
    assert np.abs(x_hat - direct).max() <= 0.5 / 255.0 + 1e-6


def test_optimized_roundtrip_exact_with_nonzero_deltas(codecs, crops):
    _, c = codecs
    y_star = port_y_star(c, crops)
    zm_opt, zl_opt = optimized_posterior(c, y_star)
    blob, info = c.compress_optimized(crops, y_star, zm_opt, zl_opt, seed=7)
    pixels = c.last_pixels
    assert info["delta_bpp"] > 0 and info["dm_bytes"] > 0 and info["dl_bytes"] > 0
    for decode in (c.decompress_optimized, c.decompress):
        x_hat, init_ok = decode(blob)
        assert init_ok
        np.testing.assert_array_equal(_pixels(x_hat), pixels)
    with pytest.raises(ValueError, match="not an optimized-posterior stream"):
        c.decompress_optimized(c.compress(crops, seed=7)[0])


def test_chained_initial_bits_pay_for_one_image(codecs, crops):
    """Only the first image draws initial bits, trimmed to what its pop
    consumes: far under the 4-bytes-per-element bound, and about the same
    for one image and for two."""
    _, c = codecs
    _, one = c.compress(crops[:1], seed=3)
    _, two = c.compress(crops, seed=3)
    assert two["init_bytes"] <= 2 * one["init_bytes"]
    assert one["init_bytes"] < (4 * 4 * 4 * 192 + 64) / 2
    assert {"device", "q_tables", "rans"} <= set(c.last_timing)


def test_wrong_seed_or_corrupted_stack_fails_the_check(codecs, crops):
    _, c = codecs
    blob, _ = c.compress(crops, seed=2)
    packed = PackedBitstream.unpack(blob)
    packed.add_ints("seed", [3])
    x_hat, init_ok = c.decompress(packed.pack())
    assert not init_ok
    np.testing.assert_array_equal(_pixels(x_hat), c.last_pixels)

    packed = PackedBitstream.unpack(blob)
    stack = bytearray(packed.get_stream("z_stack"))
    stack[len(stack) // 2] ^= 0x5A
    packed.add_stream("z_stack", bytes(stack))
    _, init_ok = c.decompress(packed.pack())
    assert not init_ok


def test_deterministic(codecs, crops):
    _, c = codecs
    assert c.compress(crops[:1], seed=2)[0] == c.compress(crops[:1], seed=2)[0]
