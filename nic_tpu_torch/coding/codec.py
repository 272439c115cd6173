"""End-to-end bitstream codec for the mean-scale hyperprior
(counterpart of nic_tpu/coding/codec.py).

The device computes integer symbols and CDF-row indexes; the host rANS
coder turns them into bytes. The bitstream is self-contained given
(runname, num_filters): z decodes against the factorized-prior table, then
mu and the scale indexes = h_s(z_hat) select per-element rows of the
Gaussian scale table to decode y, then x_hat = g_s(y_hat). Streams use the
same container and tables as nic_tpu's.

Determinism. The decoder recomputes mu and the scale indexes with h_s on
the device and must pick the very index the encoder picked for every
element: one differing index means the wrong CDF from there on. So the
encoder derives its indexes, its y symbols and its reconstruction with the
decoder's own passes, fed the same host arrays, and every device pass runs
with cuDNN's deterministic algorithms, no autotuning and TF32 off. A stream
decodes exactly with the same code, on the same device type, at the same
batch shape.

Transfers follow nic_tpu's default decode semantics ("single_stream_slim"):
scale indexes come to the host as uint8 (64 levels), y symbols go to the
device as int16 where they fit, and the reconstruction comes back as uint8
pixels; ``decompress`` returns them as float pixels / 255. nic_tpu's
``NIC_TPU_DECODE_*`` variants exist for its TPU transfers and are not ported.
"""

import contextlib
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from nic_tpu_torch import config
from nic_tpu_torch.coding.coder import RansCoder
from nic_tpu_torch.coding.container import PackedBitstream
from nic_tpu_torch.coding.tables import CdfTable
from nic_tpu_torch.models.conditional import GaussianConditional
from nic_tpu_torch.models.mbt2018 import MeanScaleHyperprior
from nic_tpu_torch.utils import convert_uint8_to_float

_GC = GaussianConditional()


@contextlib.contextmanager
def _deterministic():
    """No autograd, cuDNN's deterministic algorithms, no autotuning, no TF32."""
    with torch.no_grad(), torch.backends.cudnn.flags(
        enabled=True, benchmark=False, deterministic=True, allow_tf32=False
    ):
        yield


def _narrow(y_symbols: np.ndarray) -> np.ndarray:
    """int16 for the upload of the y symbols when the range allows (it does
    in practice: symbols live within the coding-table support; escaped
    outliers could exceed it, so check)."""
    if np.abs(y_symbols).max(initial=0) < 32000:
        return y_symbols.astype(np.int16)
    return y_symbols


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


# ------------------------------------------------------------ device passes


def _mu_sigma_pass(model, z_hat, y_hw):
    """h_s of z_hat -> (mu, sigma, uint8 scale indexes)."""
    mu, sigma = model.hyper_synthesize(z_hat.contiguous(), y_hw)
    indexes = _GC.scale_indexes(_GC.bound_scale(sigma)).to(torch.uint8)
    return mu, sigma, indexes


def _z_symbols_to_mu_sigma(model, z_symbols, y_hw):
    """Decode pass 1: median-dequantize the z symbols and run h_s ->
    (z_hat, mu, sigma, uint8 scale indexes)."""
    z_hat = z_symbols.float() + model.medians()
    return (z_hat, *_mu_sigma_pass(model, z_hat, y_hw))


def _synthesize(model, y_symbols, mu, x_hw, round_mu: bool):
    """Mean-dequantize the y symbols (center round(mu) for optimized
    latents) and run g_s -> (y_hat, unclipped reconstruction)."""
    center = torch.round(mu) if round_mu else mu
    y_hat = y_symbols.float() + center
    return y_hat, model.synthesize(y_hat.contiguous(), x_hw)


def _to_pixels(x_tilde):
    """Clip to [0, 1] and quantize to uint8 PNG pixels, on the device."""
    return torch.round(torch.clamp(x_tilde, 0.0, 1.0) * 255.0).to(torch.uint8)


def _reconstruct_pass(model, y_symbols, mu, x_hw, round_mu: bool = False):
    """Decode pass 2: y symbols -> uint8 pixels."""
    return _to_pixels(_synthesize(model, y_symbols, mu, x_hw, round_mu)[1])


def _split(blob: bytes, sizes):
    outs, pos = [], 0
    for s in sizes:
        outs.append(blob[pos: pos + s])
        pos += s
    return outs


class DeviceCodec:
    """What the codecs share: the model on ``device`` (the card unless the
    caller asks for the CPU), the rANS coder, the Gaussian scale table and
    the timing. ``last_timing`` holds the milliseconds of the last public
    call, split into ``device`` (device passes and their transfers, host
    clock after the copies that end them), ``rans`` (host coding) and
    ``tables`` (building a CDF table at first use). ``last_pixels`` holds
    the uint8 reconstruction that decoding the last stream written gives
    (times 255), computed by the decoder's own passes.
    """

    def __init__(self, model: torch.nn.Module, device="cuda"):
        config.set_fp32_precision()
        self.device = config.resolve_device(device)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.coder = RansCoder()
        self._y_table: Optional[CdfTable] = None
        self.last_timing: Dict[str, float] = {}
        self.last_pixels: Optional[np.ndarray] = None

    @contextlib.contextmanager
    def _phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            ms = (time.perf_counter() - t0) * 1e3
            self.last_timing[name] = self.last_timing.get(name, 0.0) + ms

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _table(self, make_pmf) -> CdfTable:
        with self._phase("tables"):
            pmf = [_host(t) if torch.is_tensor(t) else t for t in make_pmf()]
            return CdfTable.from_pmf(*pmf)

    def y_table(self) -> CdfTable:
        """Per-scale-level Gaussian CDF tables."""
        if self._y_table is None:
            self._y_table = self._table(_GC.pmfs_for_coding)
        return self._y_table


class HyperpriorCodec(DeviceCodec):
    """Bitstream encoder/decoder around a trained MeanScaleHyperprior
    (``last_timing`` and ``last_pixels``: see ``DeviceCodec``; the latter
    is set by ``compress``, ``compress_latents`` and ``compress_optimized``).
    """

    def __init__(self, model: MeanScaleHyperprior, device="cuda"):
        super().__init__(model, device)
        self._z_table: Optional[CdfTable] = None
        self._z_int_table: Optional[CdfTable] = None

    # ------------------------------------------------------------- tables

    def z_table(self) -> CdfTable:
        """Factorized-prior CDF table over the median-centered integer grid."""
        if self._z_table is None:
            self._z_table = self._table(self.model.pmf_for_coding)
        return self._z_table

    def z_int_table(self) -> CdfTable:
        """Factorized-prior table over the plain integer grid, for coding
        plainly rounded z (the latents SGA transmits)."""
        if self._z_int_table is None:
            self._z_int_table = self._table(
                lambda: self.model.pmf_for_coding(grid="integer"))
        return self._z_int_table

    def _z_rows(self, shape):
        return np.broadcast_to(np.arange(shape[-1], dtype=np.int32), shape)

    # --------------------------------------------------------------- public

    def compress(self, x: np.ndarray, parallel: bool = False
                 ) -> Tuple[bytes, Dict[str, Any]]:
        """Compress a [N,H,W,3] float batch in [0,1] into one bitstream.

        parallel=False encodes one whole-batch rANS stream; parallel=True one
        stream per image across C++ threads, which also lets the decoder
        run in parallel. Returns (packed bytes, outputs): the eval forward's
        tensors under nic_tpu's keys (y, z, z_tilde, z_likelihoods, mu,
        sigma, y_tilde, y_likelihoods, x_tilde), the host symbols and
        indexes (z_symbols, y_symbols, y_indexes), and ``pixels``, the uint8
        reconstruction that ``decompress`` returns (times 255).
        """
        self.last_timing = {}
        zt, yt = self.z_table(), self.y_table()
        model = self.model
        with self._phase("device"), _deterministic():
            xt = self._upload(np.asarray(x, np.float32))
            y = model.analyze(xt)
            z = model.hyper_analyze(y)
            z_symbols = _host(torch.round(z - model.medians()).to(torch.int32))
            y_hw, x_hw = (y.shape[1], y.shape[2]), (x.shape[1], x.shape[2])
            z_hat, mu, sigma, idx = _z_symbols_to_mu_sigma(
                model, self._upload(z_symbols), y_hw)
            y_symbols = _host(_GC.symbols(y, mu))
            y_indexes = _host(idx).astype(np.int32)
            y_tilde, x_tilde = _synthesize(
                model, self._upload(_narrow(y_symbols)), mu, x_hw, False)
            out = dict(
                y=y, z=z, z_tilde=z_hat, z_likelihoods=model.z_likelihood(z_hat),
                mu=mu, sigma=sigma, y_tilde=y_tilde,
                y_likelihoods=model.y_likelihood(y_tilde, mu, sigma),
                x_tilde=x_tilde, z_symbols=z_symbols, y_symbols=y_symbols,
                y_indexes=y_indexes, pixels=_host(_to_pixels(x_tilde)),
            )
            self.last_pixels = out["pixels"]

        with self._phase("rans"):
            z_rows = self._z_rows(z_symbols.shape)
            z_rel = zt.symbols_from_values(z_symbols, z_rows)
            y_rel = yt.symbols_from_values(y_symbols, y_indexes)
            packed = PackedBitstream()
            if parallel:
                side_streams = self.coder.encode_batch(z_rel, z_rows, zt.cdfs,
                                                       zt.cdf_sizes)
                y_streams = self.coder.encode_batch(y_rel, y_indexes, yt.cdfs,
                                                    yt.cdf_sizes)
                packed.add_stream("string", b"".join(y_streams))
                packed.add_stream("side_string", b"".join(side_streams))
                packed.add_ints("string_sizes", [len(s) for s in y_streams])
                packed.add_ints("side_string_sizes", [len(s) for s in side_streams])
            else:
                packed.add_stream("side_string", self.coder.encode(
                    z_rel, z_rows, zt.cdfs, zt.cdf_sizes))
                packed.add_stream("string", self.coder.encode(
                    y_rel, y_indexes, yt.cdfs, yt.cdf_sizes))
            packed.add_ints("x_shape", x.shape[1:3])
            packed.add_ints("y_shape", y_symbols.shape[1:3])
            packed.add_ints("z_shape", z_symbols.shape[1:3])
            packed.add_ints("batch", [x.shape[0]])
            blob = packed.pack()
        return blob, out

    def compress_latents(self, y_q: np.ndarray, z_hat: np.ndarray, x_hw) -> bytes:
        """Serialize median/mean-centered quantized latents (z_hat =
        round(z - median) + median, y_q = round(y - mu) + mu with mu =
        h_s(z_hat)) into a stream that plain ``decompress`` decodes: the
        symbols are the integers the amortized scheme would code.
        ``last_pixels`` holds the uint8 pixels that ``decompress`` returns."""
        self.last_timing = {}
        zt, yt = self.z_table(), self.y_table()
        model = self.model
        with self._phase("device"), _deterministic():
            medians = model.medians()
            z_symbols = _host(torch.round(self._upload(np.asarray(z_hat, np.float32))
                                          - medians).to(torch.int32))
            y_hw = (y_q.shape[1], y_q.shape[2])
            _, mu, _, idx = _z_symbols_to_mu_sigma(model, self._upload(z_symbols), y_hw)
            y_symbols = _host(torch.round(self._upload(np.asarray(y_q, np.float32))
                                          - mu).to(torch.int32))
            y_indexes = _host(idx).astype(np.int32)
            # The decoder's own reconstruction of these symbols.
            self.last_pixels = _host(_reconstruct_pass(
                model, self._upload(_narrow(y_symbols)), mu, tuple(x_hw)))
        with self._phase("rans"):
            z_rows = self._z_rows(z_symbols.shape)
            packed = PackedBitstream()
            packed.add_stream("side_string", self.coder.encode(
                zt.symbols_from_values(z_symbols, z_rows), z_rows, zt.cdfs,
                zt.cdf_sizes))
            packed.add_stream("string", self.coder.encode(
                yt.symbols_from_values(y_symbols, y_indexes), y_indexes, yt.cdfs,
                yt.cdf_sizes))
            packed.add_ints("x_shape", x_hw)
            packed.add_ints("y_shape", y_q.shape[1:3])
            packed.add_ints("z_shape", z_hat.shape[1:3])
            packed.add_ints("batch", [y_q.shape[0]])
            return packed.pack()

    def compress_optimized(self, y_star: np.ndarray, z_star: np.ndarray, x_hw) -> bytes:
        """Serialize latents produced by SGA-style plain rounding into a real
        bitstream (mode=1): z on the integer grid against the integer-grid
        factorized table, y as y_star - round(mu) against the scale tables."""
        self.last_timing = {}
        zt, yt = self.z_int_table(), self.y_table()
        z_int = np.asarray(z_star).astype(np.int32)
        with self._phase("device"), _deterministic():
            y_hw = (y_star.shape[1], y_star.shape[2])
            mu, _, idx = _mu_sigma_pass(self.model, self._upload(z_int).float(), y_hw)
            y_symbols = _host((self._upload(np.asarray(y_star, np.float32))
                               - torch.round(mu)).to(torch.int32))
            y_indexes = _host(idx).astype(np.int32)
            self.last_pixels = _host(_reconstruct_pass(
                self.model, self._upload(_narrow(y_symbols)), mu, tuple(x_hw),
                round_mu=True))
        with self._phase("rans"):
            z_rows = self._z_rows(z_int.shape)
            side_string = self.coder.encode(
                zt.symbols_from_values(z_int, z_rows), z_rows, zt.cdfs, zt.cdf_sizes)
            string = self.coder.encode(
                yt.symbols_from_values(y_symbols, y_indexes), y_indexes, yt.cdfs,
                yt.cdf_sizes)
            packed = PackedBitstream()
            packed.add_stream("string", string)
            packed.add_stream("side_string", side_string)
            packed.add_ints("x_shape", x_hw)
            packed.add_ints("y_shape", y_star.shape[1:3])
            packed.add_ints("z_shape", z_star.shape[1:3])
            packed.add_ints("batch", [y_star.shape[0]])
            packed.add_ints("mode", [1])  # integer-grid latents
            return packed.pack()

    def decompress_optimized(self, blob: bytes) -> np.ndarray:
        """Inverse of compress_optimized: float [N,H,W,3] pixels / 255."""
        packed = PackedBitstream.unpack(blob)
        mode = packed.get_ints("mode")[0] if packed.has_ints("mode") else 0
        if mode != 1:
            raise ValueError(
                f"bitstream mode={mode} is not an optimized-latent (mode=1) "
                "stream; decode it with decompress()"
            )
        self.last_timing = {}
        n = packed.get_ints("batch")[0]
        xh, xw = packed.get_ints("x_shape")
        yh, yw = packed.get_ints("y_shape")
        zh, zw = packed.get_ints("z_shape")
        zt, yt = self.z_int_table(), self.y_table()
        with self._phase("rans"):
            z_rows = self._z_rows((n, zh, zw, self.model.num_filters))
            z_rel = self.coder.decode(packed.get_stream("side_string"), z_rows,
                                      zt.cdfs, zt.cdf_sizes)
            z_int = zt.values_from_symbols(z_rel, z_rows)
        with self._phase("device"), _deterministic():
            mu, _, idx = _mu_sigma_pass(self.model, self._upload(z_int).float(),
                                        (yh, yw))
            y_indexes = _host(idx).astype(np.int32)
        with self._phase("rans"):
            y_rel = self.coder.decode(packed.get_stream("string"), y_indexes,
                                      yt.cdfs, yt.cdf_sizes)
            y_symbols = _narrow(yt.values_from_symbols(y_rel, y_indexes))
        with self._phase("device"), _deterministic():
            pixels = _host(_reconstruct_pass(self.model, self._upload(y_symbols), mu,
                                             (xh, xw), round_mu=True))
        return convert_uint8_to_float(pixels)

    def decompress(self, blob: bytes) -> np.ndarray:
        """Inverse of compress: bitstream -> float [N,H,W,3] pixels / 255.
        Optimized-latent streams (mode=1) carry integer-grid latents coded
        against other tables, so they go to ``decompress_optimized``."""
        packed = PackedBitstream.unpack(blob)
        if packed.has_ints("mode") and packed.get_ints("mode")[0] == 1:
            return self.decompress_optimized(blob)
        self.last_timing = {}
        n = packed.get_ints("batch")[0]
        xh, xw = packed.get_ints("x_shape")
        yh, yw = packed.get_ints("y_shape")
        zh, zw = packed.get_ints("z_shape")
        zt, yt = self.z_table(), self.y_table()
        side_sizes = (packed.get_ints("side_string_sizes")
                      if packed.has_ints("side_string_sizes") else None)

        def decode(name, indexes, table):
            if side_sizes is None:
                return self.coder.decode(packed.get_stream(name), indexes,
                                         table.cdfs, table.cdf_sizes)
            sizes = packed.get_ints(f"{name}_sizes")
            return self.coder.decode_batch(_split(packed.get_stream(name), sizes),
                                           indexes, table.cdfs, table.cdf_sizes)

        with self._phase("rans"):
            z_rows = self._z_rows((n, zh, zw, self.model.num_filters))
            z_symbols = zt.values_from_symbols(decode("side_string", z_rows, zt),
                                               z_rows)
        with self._phase("device"), _deterministic():
            _, mu, _, idx = _z_symbols_to_mu_sigma(self.model, self._upload(z_symbols),
                                                   (yh, yw))
            y_indexes = _host(idx).astype(np.int32)
        with self._phase("rans"):
            y_rel = decode("string", y_indexes, yt)
            y_symbols = _narrow(yt.values_from_symbols(y_rel, y_indexes))
        with self._phase("device"), _deterministic():
            pixels = _host(_reconstruct_pass(self.model, self._upload(y_symbols), mu,
                                             (xh, xw)))
        return convert_uint8_to_float(pixels)
