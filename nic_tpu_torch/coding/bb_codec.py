"""Real bits-back bitstreams (BB-ANS) for the bits-back hyperprior
(counterpart of nic_tpu/coding/bb_codec.py, with its stream format).

Encode, per image: y* = round(g_a(x)) is coded against the scale-indexed
Gaussian tables. On a rANS stack seeded with deterministic initial bits,
z-bins are POPPED under the posterior q(z | y*) = N(h_a(y*)) (the
bits-back "sample", which consumes ~H(q) bits), then PUSHED under the prior
p(z). Decode: pop z under p, decode y* with p(y | z), x_hat = g_s(y*), and
push the bins back under q(z | h_a(y*)): this returns the borrowed bits,
and the stack must end equal to the encoder's initial bits (the integrity
check). z lives on a uniform grid of width ``delta`` over [grid_lo,
grid_hi]; the tails fold into the edge bins.

Images are CHAINED on one stack by default: image i's posterior pop
consumes the bits image i-1 pushed, so only the first image draws initial
bits, trimmed to what its pop consumes. The decoder unwinds in reverse
image order. ``chained=False`` writes nic_tpu's earlier format, one pop
and one push over the whole batch.

``compress_optimized`` makes a per-image optimized posterior (from
``infer/bb.py``) decodable: the encoder sends its quantized deltas from
the amortized posterior under a Laplacian prior, and both sides pop and
push under amortized + deltas.

Determinism. The decoder recomputes mu and the scale indexes from z_tilde
(h_s), and the posterior from y* (h_a), on the device; one ulp of
difference can move a CDF entry and break the push/pop inverse. So the
encoder derives the posterior, mu, the scale indexes and the
reconstruction image by image at batch 1, through the decoder's own
passes, fed the same host arrays, under ``codec._deterministic()``. A
stream decodes exactly with the same code on the same device type. The
posterior tables are built on the host in float64 (scipy's erfc), as in
nic_tpu, so both sides' tables are bit-identical.
"""

import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from nic_tpu_torch.coding.codec import (
    DeviceCodec,
    _deterministic,
    _host,
    _mu_sigma_pass,
    _narrow,
    _split,
    _to_pixels,
)
from nic_tpu_torch.coding.coder import RansStack
from nic_tpu_torch.coding.container import PackedBitstream
from nic_tpu_torch.coding.tables import pmf_to_quantized_cdf_fast
from nic_tpu_torch.models.mbt2018_bb import BitsBackHyperprior
from nic_tpu_torch.utils import convert_uint8_to_float

Deltas = Optional[Tuple[np.ndarray, np.ndarray]]


class BitsBackCodec(DeviceCodec):
    """BB-ANS bitstreams for a trained BitsBackHyperprior.

    ``last_timing`` (see ``DeviceCodec``) adds ``q_tables``, the host time
    of the per-image posterior tables. ``last_pixels`` is set by
    ``compress`` and ``compress_optimized``.
    """

    grid_lo = -20.0        # z's coding grid: [grid_lo, grid_hi] in bins of delta
    grid_hi = 20.0
    delta = 0.125
    num_bins = 320
    DELTA_Q = 0.125        # posterior-parameter quantization step
    DELTA_CLIP = 96        # delta symbols clipped to [-CLIP, CLIP]
    _INIT_MARGIN = 64      # bytes of slack kept above the measured consumption

    def __init__(self, model: BitsBackHyperprior, device="cuda"):
        super().__init__(model, device)
        self._p_table = None

    # -------------------------------------------------------------- tables

    def p_table(self):
        """The prior's bin CDFs per channel over the shared grid."""
        if self._p_table is None:
            with self._phase("tables"), torch.no_grad():
                pmf = self.model.hyper_prior.pmf_on_grid(self.grid_lo, self.grid_hi,
                                                         self.delta)
                self._p_table = pmf_to_quantized_cdf_fast(_host(pmf).astype(np.float64))
        return self._p_table

    def q_tables(self, z_mean: np.ndarray, z_logvar: np.ndarray):
        """Per-element posterior bin CDFs over the shared grid (host float64)."""
        from scipy.special import erfc

        with self._phase("q_tables"):
            mu = np.asarray(z_mean, np.float64).reshape(-1, 1)
            sigma = np.exp(np.asarray(z_logvar, np.float64).reshape(-1, 1) * 0.5)
            edges = self.grid_lo + self.delta * np.arange(1, self.num_bins)[None, :]
            cdf = 0.5 * erfc(-(edges - mu) / (sigma * np.sqrt(2.0)))
            cdf = np.concatenate(
                [np.zeros((mu.shape[0], 1)), cdf, np.ones((mu.shape[0], 1))], axis=1)
            return pmf_to_quantized_cdf_fast(np.diff(cdf, axis=1))

    def _laplace_table(self, scale_int: int):
        """One-row quantized CDF of a discretized Laplacian over [-CLIP,
        CLIP], tails folded into the edge bins; b = scale_int / 256."""
        b = max(scale_int, 1) / 256.0
        k = np.arange(-self.DELTA_CLIP, self.DELTA_CLIP + 1, dtype=np.float64)
        pmf = np.exp(-np.abs(k) / b)
        return pmf_to_quantized_cdf_fast(pmf[None, :] / pmf.sum())

    def _grid_centers(self, bins: np.ndarray) -> np.ndarray:
        return self.grid_lo + (bins.astype(np.float32) + 0.5) * self.delta

    # --------------------------------------------------------- initial bits

    def _seeded_stack(self, seed, n_elem, q_rows, q_cdfs, q_sizes):
        """A stack whose initial bits are trimmed to what the posterior pop
        consumes (+ margin): pass 1 pops against a generous seed to measure
        the consumption, pass 2 re-seeds with just the consumed suffix (the
        pop reads bytes strictly from the top of the initial buffer, so the
        suffix gives the same bins). Returns (stack after the pop, z_bins,
        kept bytes, total bytes)."""
        init_total = 4 * n_elem + 64
        init = np.random.default_rng(seed).bytes(init_total)
        probe = RansStack(init)
        s0 = len(probe)
        z_bins = probe.pop(q_rows, q_cdfs, q_sizes)
        kept = min(init_total, max(0, s0 - len(probe)) + self._INIT_MARGIN)
        stack = RansStack(init[init_total - kept:])
        z_bins2 = stack.pop(q_rows, q_cdfs, q_sizes)
        if not np.array_equal(z_bins, z_bins2):  # pragma: no cover
            # The margin was too small: keep the untrimmed seed.
            stack = RansStack(init)
            return stack, stack.pop(q_rows, q_cdfs, q_sizes), init_total, init_total
        return stack, z_bins2, kept, init_total

    @staticmethod
    def _expected_initial(seed, init_total, kept) -> bytes:
        """The stack's serialized state right after seeding: the LE32 rANS
        lower bound, then the kept suffix of the initial bits."""
        init = np.random.default_rng(seed).bytes(init_total)
        return struct.pack("<I", 1 << 23) + init[init_total - kept:]

    # ------------------------------------------------------- device passes

    def _decode_image(self, y_star: torch.Tensor, x_hw):
        """One image's uint8 pixels and amortized posterior from its y*
        (batch 1, on the device): the decoder's pass, which the encoder
        runs too."""
        y_star = y_star.contiguous()
        pixels = _host(_to_pixels(self.model.synthesize(y_star, x_hw)))
        z_mean, z_logvar = self.model.hyper_posterior(y_star)
        return pixels, _host(z_mean), _host(z_logvar)

    def _mu_indexes(self, z_tilde: np.ndarray, y_hw):
        """Per image at batch 1: (mu on the device, int32 scale indexes on
        the host) from host z_tilde."""
        mus, idx = [], []
        for i in range(z_tilde.shape[0]):
            mu, _, ix = _mu_sigma_pass(self.model, self._upload(z_tilde[i:i + 1]), y_hw)
            mus.append(mu)
            idx.append(_host(ix).astype(np.int32))
        return mus, np.concatenate(idx)

    def _amortized(self, y_star: np.ndarray, x_hw):
        """Pixels and amortized posterior of every image of host y*."""
        with self._phase("device"), _deterministic():
            outs = [self._decode_image(self._upload(y_star[i:i + 1]), x_hw)
                    for i in range(y_star.shape[0])]
        return tuple(np.concatenate(a) for a in zip(*outs))

    # -------------------------------------------------------------- encode

    def _groups(self, n: int, chained: bool) -> List[List[int]]:
        """The images each pop/push covers: one each when chained, else all."""
        return [[i] for i in range(n)] if chained else [list(range(n))]

    def _encode(self, y_star, z_mean_hat, z_logvar_hat, seed: int, chained: bool):
        """The bits-back coding loop over host arrays: returns (y streams,
        z stack bytes, kept initial bytes, total initial bytes)."""
        yt = self.y_table()
        p_cdfs, p_sizes = self.p_table()
        z_shape1 = z_mean_hat.shape[1:]
        img_elems = int(np.prod(z_shape1))
        p_rows1 = np.broadcast_to(np.arange(z_shape1[-1], dtype=np.int32),
                                  z_shape1).reshape(-1)
        y_hw = y_star.shape[1:3]
        y_streams, stack = [], None
        init_len = init_total = 0
        for g in self._groups(y_star.shape[0], chained):
            q_cdfs, q_sizes = self.q_tables(z_mean_hat[g], z_logvar_hat[g])
            q_rows = np.arange(len(g) * img_elems, dtype=np.int32)
            with self._phase("rans"):
                if stack is None:  # only the first group draws initial bits
                    stack, z_bins, init_len, init_total = self._seeded_stack(
                        seed, q_rows.size, q_rows, q_cdfs, q_sizes)
                else:
                    z_bins = stack.pop(q_rows, q_cdfs, q_sizes)
            z_tilde = self._grid_centers(z_bins).reshape((len(g),) + z_shape1)
            with self._phase("device"), _deterministic():
                mus, y_rows = self._mu_indexes(z_tilde, y_hw)
                mu_r = np.concatenate([_host(torch.round(mu)) for mu in mus])
            with self._phase("rans"):
                y_sym = (y_star[g] - mu_r).astype(np.int32)
                y_streams.append(self.coder.encode(
                    y_sym - yt.offsets[y_rows], y_rows, yt.cdfs, yt.cdf_sizes))
                stack.push(z_bins, np.tile(p_rows1, len(g)), p_cdfs, p_sizes)
        with self._phase("rans"):
            z_stream = stack.serialize()
        return y_streams, z_stream, init_len, init_total

    def _pack(self, x_hw, y_star, z_hw, seed, y_streams, z_stream, init_len,
              init_total, chained, deltas=None) -> bytes:
        """The container, in nic_tpu's field order."""
        packed = PackedBitstream()
        packed.add_stream("string", b"".join(y_streams))
        if chained:
            packed.add_ints("string_sizes", [len(s) for s in y_streams])
        packed.add_stream("z_stack", z_stream)
        if deltas is not None:
            packed.add_stream("dm", deltas[0])
            packed.add_stream("dl", deltas[1])
        packed.add_ints("x_shape", x_hw)
        packed.add_ints("y_shape", y_star.shape[1:3])
        packed.add_ints("z_shape", z_hw)
        packed.add_ints("batch", [y_star.shape[0]])
        packed.add_ints("seed", [seed])
        packed.add_ints("init_bits", [init_len])
        packed.add_ints("init_total", [init_total])
        if deltas is not None:
            packed.add_ints("post_delta", deltas[2])
        packed.add_ints("chained", [int(chained)])
        return packed.pack()

    @staticmethod
    def _info(blob, num_pixels, y_streams, z_stream, init_len) -> Dict[str, Any]:
        return dict(
            actual_bpp=len(blob) * 8 / num_pixels,
            net_bpp=(len(blob) - init_len) * 8 / num_pixels,
            y_stream_bytes=sum(len(s) for s in y_streams),
            z_stack_bytes=len(z_stream),
            init_bytes=init_len,
        )

    @staticmethod
    def _canonical(y_star) -> np.ndarray:
        """Host float32 y* with -0.0 made +0.0, the value the decoder's
        symbols + round(mu) gives."""
        return np.asarray(y_star, np.float32) + np.float32(0.0)

    def compress(self, x: np.ndarray, seed: int = 0, chained: bool = True
                 ) -> Tuple[bytes, Dict[str, Any]]:
        """One bitstream for a [N,H,W,3] float batch in [0,1], coded against
        the amortized posterior. Returns (bytes, info): ``actual_bpp``,
        ``net_bpp`` (without the initial bits, which the decoder returns),
        ``y_stream_bytes``, ``z_stack_bytes``, ``init_bytes``."""
        self.last_timing = {}
        x_hw = x.shape[1:3]
        with self._phase("device"), _deterministic():
            y_star = self._canonical(_host(torch.round(self.model.analyze(
                self._upload(np.asarray(x, np.float32))))))
        pixels, z_mean, z_logvar = self._amortized(y_star, x_hw)
        self.last_pixels = pixels
        y_streams, z_stream, init_len, init_total = self._encode(
            y_star, z_mean, z_logvar, seed, chained)
        blob = self._pack(x_hw, y_star, z_mean.shape[1:3], seed, y_streams, z_stream,
                          init_len, init_total, chained)
        return blob, self._info(blob, int(np.prod(x.shape[:3])), y_streams, z_stream,
                                init_len)

    def _quantize_posterior(self, z_mean_opt, z_logvar_opt, z_mean0, z_logvar0):
        """(dm, dl) int32 delta symbols and the posterior both sides use."""
        q = self.DELTA_Q
        z_mean0 = np.asarray(z_mean0, np.float64)
        z_logvar0 = np.asarray(z_logvar0, np.float64)
        dm = np.clip(np.round((np.asarray(z_mean_opt, np.float64) - z_mean0) / q),
                     -self.DELTA_CLIP, self.DELTA_CLIP).astype(np.int32)
        dl = np.clip(np.round((np.asarray(z_logvar_opt, np.float64) - z_logvar0) / q),
                     -self.DELTA_CLIP, self.DELTA_CLIP).astype(np.int32)
        return dm, dl, *self._posterior_hat(z_mean0, z_logvar0, dm, dl)

    def _posterior_hat(self, z_mean0, z_logvar0, dm, dl):
        """Amortized posterior + quantized deltas, float32."""
        q = self.DELTA_Q
        return ((np.asarray(z_mean0, np.float64) + dm * q).astype(np.float32),
                (np.asarray(z_logvar0, np.float64) + dl * q).astype(np.float32))

    def compress_optimized(self, x: np.ndarray, y_star: np.ndarray, z_mean_opt: np.ndarray,
                           z_logvar_opt: np.ndarray, seed: int = 0, chained: bool = True
                           ) -> Tuple[bytes, Dict[str, Any]]:
        """Bits-back encode with a per-image optimized posterior (the output
        of ``BBLatentOptimizer.optimize``), made decodable by quantized
        deltas from the amortized posterior. ``info`` adds ``delta_bpp``
        (the rate paid to send the posterior), ``dm_bytes`` and ``dl_bytes``
        to ``compress``'s."""
        self.last_timing = {}
        x_hw = x.shape[1:3]
        y_star = self._canonical(y_star)
        pixels, z_mean0, z_logvar0 = self._amortized(y_star, x_hw)
        self.last_pixels = pixels
        dm, dl, z_mean_hat, z_logvar_hat = self._quantize_posterior(
            z_mean_opt, z_logvar_opt, z_mean0, z_logvar0)
        with self._phase("rans"):
            # Delta streams under per-tensor Laplacian priors, scales in the header.
            scales = [max(1, int(round(np.mean(np.abs(d)) * 256))) for d in (dm, dl)]
            rows = np.zeros(dm.size, np.int32)
            dm_stream, dl_stream = (
                self.coder.encode(d.reshape(-1) + self.DELTA_CLIP, rows,
                                  *self._laplace_table(s))
                for d, s in zip((dm, dl), scales))
        y_streams, z_stream, init_len, init_total = self._encode(
            y_star, z_mean_hat, z_logvar_hat, seed, chained)
        blob = self._pack(x_hw, y_star, z_mean_hat.shape[1:3], seed, y_streams, z_stream,
                          init_len, init_total, chained, (dm_stream, dl_stream, scales))
        num_pixels = int(np.prod(x.shape[:3]))
        return blob, dict(
            self._info(blob, num_pixels, y_streams, z_stream, init_len),
            delta_bpp=(len(dm_stream) + len(dl_stream)) * 8 / num_pixels,
            dm_bytes=len(dm_stream),
            dl_bytes=len(dl_stream),
        )

    # -------------------------------------------------------------- decode

    def decompress(self, blob: bytes) -> Tuple[np.ndarray, bool]:
        """Decode a ``compress`` or ``compress_optimized`` stream, chained or
        not. Returns (float [N,H,W,3] pixels / 255, whether the initial bits
        came back)."""
        packed = PackedBitstream.unpack(blob)
        if packed.has_ints("post_delta"):
            return self.decompress_optimized(blob)
        self.last_timing = {}
        return self._decode(packed, None)

    def decompress_optimized(self, blob: bytes) -> Tuple[np.ndarray, bool]:
        """Decode a ``compress_optimized`` stream; returns (pixels / 255,
        init_ok)."""
        packed = PackedBitstream.unpack(blob)
        if not packed.has_ints("post_delta"):
            raise ValueError("not an optimized-posterior stream (no post_delta); "
                             "decode it with decompress()")
        self.last_timing = {}
        n = packed.get_ints("batch")[0]
        zh, zw = packed.get_ints("z_shape")
        z_shape = (n, zh, zw, self.model.num_filters)
        rows = np.zeros(int(np.prod(z_shape)), np.int32)
        with self._phase("rans"):
            dm, dl = (
                (self.coder.decode(packed.get_stream(name), rows, *self._laplace_table(s))
                 - self.DELTA_CLIP).reshape(z_shape)
                for name, s in zip(("dm", "dl"), packed.get_ints("post_delta")))
        return self._decode(packed, (dm, dl))

    def _decode(self, packed: PackedBitstream, deltas: Deltas) -> Tuple[np.ndarray, bool]:
        """Unwind the groups in reverse order: pop z under the prior, decode
        y*, reconstruct, and push the bins back under the (amortized +
        deltas) posterior; then compare the stack with the initial bits."""
        n = packed.get_ints("batch")[0]
        x_hw = tuple(packed.get_ints("x_shape"))
        y_hw = tuple(packed.get_ints("y_shape"))
        zh, zw = packed.get_ints("z_shape")
        seed = packed.get_ints("seed")[0]
        init_len = packed.get_ints("init_bits")[0]
        init_total = (packed.get_ints("init_total")[0] if packed.has_ints("init_total")
                      else init_len)
        chained = bool(packed.has_ints("chained") and packed.get_ints("chained")[0])
        c = self.model.num_filters
        z_shape1 = (zh, zw, c)
        img_elems = zh * zw * c
        groups = self._groups(n, chained)
        y_blob = packed.get_stream("string")
        y_streams = (_split(y_blob, packed.get_ints("string_sizes")) if chained
                     else [y_blob])
        yt = self.y_table()
        p_cdfs, p_sizes = self.p_table()
        p_rows1 = np.broadcast_to(np.arange(c, dtype=np.int32), z_shape1).reshape(-1)

        with self._phase("rans"):
            stack = RansStack.deserialize(packed.get_stream("z_stack"))
        pixels = [None] * n
        for g, y_stream in reversed(list(zip(groups, y_streams))):
            with self._phase("rans"):
                z_bins = stack.pop(np.tile(p_rows1, len(g)), p_cdfs, p_sizes)
            z_tilde = self._grid_centers(z_bins).reshape((len(g),) + z_shape1)
            with self._phase("device"), _deterministic():
                mus, y_rows = self._mu_indexes(z_tilde, y_hw)
            with self._phase("rans"):
                y_rel = self.coder.decode(y_stream, y_rows, yt.cdfs, yt.cdf_sizes)
                y_sym = _narrow(yt.values_from_symbols(y_rel, y_rows))
            z_mean, z_logvar = [], []
            with self._phase("device"), _deterministic():
                for j, (i, mu) in enumerate(zip(g, mus)):
                    y_star = self._upload(y_sym[j:j + 1]).float() + torch.round(mu)
                    pixels[i], zm, zl = self._decode_image(y_star, x_hw)
                    z_mean.append(zm)
                    z_logvar.append(zl)
            z_mean, z_logvar = np.concatenate(z_mean), np.concatenate(z_logvar)
            if deltas is not None:
                z_mean, z_logvar = self._posterior_hat(z_mean, z_logvar, deltas[0][g],
                                                       deltas[1][g])
            q_cdfs, q_sizes = self.q_tables(z_mean, z_logvar)
            with self._phase("rans"):
                stack.push(z_bins, np.arange(len(g) * img_elems, dtype=np.int32),
                           q_cdfs, q_sizes)
        with self._phase("rans"):
            init_ok = stack.serialize() == self._expected_initial(seed, init_total, init_len)
        return convert_uint8_to_float(np.concatenate(pixels)), bool(init_ok)
