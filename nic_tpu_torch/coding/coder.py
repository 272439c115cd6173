"""ctypes bindings for the native rANS coder (``csrc/rans.cpp``).

A copy of nic_tpu/coding/coder.py for the port. It replaces tfc's
RangeEncode/RangeDecode C++ kernels (the reference's mbt2018.py:84-85 and
269-280). The device computes integer symbols and CDF-row indexes; only
those small integer tensors cross to the host. The library is built by g++
at first use into ``nic_tpu_torch/_build/librans.so`` (``ops/build.py``).
"""

import ctypes
import os
from typing import List, Sequence

import numpy as np

from nic_tpu_torch.config import CODER_PRECISION
from nic_tpu_torch.ops.build import build_library

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def library_path() -> str:
    """Path to librans.so, built from csrc/rans.cpp if missing or stale."""
    return str(build_library("rans.cpp"))


def _load_lib():
    lib = ctypes.CDLL(library_path())
    lib.rans_stack_create.restype = ctypes.c_void_p
    lib.rans_stack_create.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.rans_stack_destroy.argtypes = [ctypes.c_void_p]
    lib.rans_stack_size.restype = ctypes.c_int64
    lib.rans_stack_size.argtypes = [ctypes.c_void_p]
    lib.rans_stack_serialize.restype = ctypes.c_int64
    lib.rans_stack_serialize.argtypes = [ctypes.c_void_p, _u8p, ctypes.c_int64]
    lib.rans_stack_deserialize.restype = ctypes.c_void_p
    lib.rans_stack_deserialize.argtypes = [_u8p, ctypes.c_int64]
    lib.rans_stack_encode.restype = ctypes.c_int64
    lib.rans_stack_encode.argtypes = [
        ctypes.c_void_p, _i32p, _i32p, ctypes.c_int64,
        _u32p, ctypes.c_int64, _i32p, ctypes.c_int32,
    ]
    lib.rans_stack_decode.restype = ctypes.c_int64
    lib.rans_stack_decode.argtypes = [
        ctypes.c_void_p, _i32p, ctypes.c_int64,
        _u32p, ctypes.c_int64, _i32p, ctypes.c_int32, _i32p,
    ]
    return lib


class RansStack:
    """Stateful LIFO rANS for bits-back coding (no escape/bypass).

    push() appends symbols; pop() removes them in reverse order. The
    convenience methods push/pop take symbols in natural order: a
    ``pop(indexes)`` exactly inverts the latest ``push(symbols, indexes)``
    with the same indexes. Popping from a fresh/short stack draws zero
    bytes — supply ``initial_bits`` when exact bit recovery matters.
    """

    def __init__(self, initial_bits: bytes = b"", precision: int = CODER_PRECISION,
                 _handle=None):
        self.precision = precision
        self._lib = _load_lib()
        if _handle is not None:
            self._h = _handle
        else:
            self._h = self._lib.rans_stack_create(initial_bits, len(initial_bits))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rans_stack_destroy(self._h)
            self._h = None

    def push(self, symbols: np.ndarray, indexes: np.ndarray, cdfs, cdf_sizes):
        symbols = np.ascontiguousarray(symbols.reshape(-1), np.int32)
        indexes = np.ascontiguousarray(indexes.reshape(-1), np.int32)
        cdfs = np.ascontiguousarray(cdfs, np.uint32)
        cdf_sizes = np.ascontiguousarray(cdf_sizes, np.int32)
        r = self._lib.rans_stack_encode(
            self._h, symbols, indexes, symbols.size,
            cdfs, cdfs.shape[1], cdf_sizes, self.precision,
        )
        if r < 0:
            raise ValueError(f"rans_stack_encode failed with code {r}")

    def pop(self, indexes: np.ndarray, cdfs, cdf_sizes) -> np.ndarray:
        shape = indexes.shape
        rev = np.ascontiguousarray(indexes.reshape(-1)[::-1], np.int32)
        cdfs = np.ascontiguousarray(cdfs, np.uint32)
        cdf_sizes = np.ascontiguousarray(cdf_sizes, np.int32)
        out = np.empty(rev.size, np.int32)
        r = self._lib.rans_stack_decode(
            self._h, rev, rev.size, cdfs, cdfs.shape[1], cdf_sizes,
            self.precision, out,
        )
        if r < 0:
            raise ValueError(f"rans_stack_decode failed with code {r}")
        return out[::-1].reshape(shape)

    def serialize(self) -> bytes:
        size = self._lib.rans_stack_size(self._h)
        out = np.empty(size, np.uint8)
        n = self._lib.rans_stack_serialize(self._h, out, size)
        if n < 0:
            raise ValueError("rans_stack_serialize failed")
        return out[:n].tobytes()

    @classmethod
    def deserialize(cls, data: bytes, precision: int = CODER_PRECISION) -> "RansStack":
        lib = _load_lib()
        buf = np.ascontiguousarray(np.frombuffer(data, np.uint8))
        h = lib.rans_stack_deserialize(buf, buf.size)
        if not h:
            raise ValueError("rans_stack_deserialize failed")
        obj = cls.__new__(cls)
        obj.precision = precision
        obj._lib = lib
        obj._h = h
        return obj

    def __len__(self) -> int:
        return int(self._lib.rans_stack_size(self._h))


class RansCoder:
    """Encode/decode int32 symbol arrays against per-row quantized CDFs."""

    def __init__(self, precision: int = CODER_PRECISION):
        self.precision = precision
        lib = ctypes.CDLL(library_path())
        lib.rans_encode.restype = ctypes.c_int64
        lib.rans_encode.argtypes = [
            _i32p, _i32p, ctypes.c_int64,
            _u32p, ctypes.c_int64, _i32p,
            ctypes.c_int32, _u8p, ctypes.c_int64,
        ]
        lib.rans_decode.restype = ctypes.c_int64
        lib.rans_decode.argtypes = [
            _u8p, ctypes.c_int64, _i32p, ctypes.c_int64,
            _u32p, ctypes.c_int64, _i32p,
            ctypes.c_int32, _i32p,
        ]
        lib.rans_encode_batch.restype = ctypes.c_int64
        lib.rans_encode_batch.argtypes = [
            _i32p, _i32p, ctypes.c_int64, ctypes.c_int32,
            _u32p, ctypes.c_int64, _i32p, ctypes.c_int32,
            _u8p, ctypes.c_int64, _i64p, ctypes.c_int32,
        ]
        lib.rans_decode_batch.restype = ctypes.c_int64
        lib.rans_decode_batch.argtypes = [
            _u8p, _i64p, _i64p, ctypes.c_int32,
            _i32p, ctypes.c_int64,
            _u32p, ctypes.c_int64, _i32p, ctypes.c_int32,
            _i32p, ctypes.c_int32,
        ]
        self._lib = lib

    def encode(
        self,
        symbols: np.ndarray,
        indexes: np.ndarray,
        cdfs: np.ndarray,
        cdf_sizes: np.ndarray,
    ) -> bytes:
        symbols = np.ascontiguousarray(symbols.reshape(-1), np.int32)
        indexes = np.ascontiguousarray(indexes.reshape(-1), np.int32)
        cdfs = np.ascontiguousarray(cdfs, np.uint32)
        cdf_sizes = np.ascontiguousarray(cdf_sizes, np.int32)
        assert symbols.size == indexes.size
        capacity = symbols.size * 8 + 1024
        out = np.empty(capacity, np.uint8)
        n = self._lib.rans_encode(
            symbols, indexes, symbols.size,
            cdfs, cdfs.shape[1], cdf_sizes,
            self.precision, out, capacity,
        )
        if n == -1:  # grow once for pathological streams
            capacity = symbols.size * 64 + 65536
            out = np.empty(capacity, np.uint8)
            n = self._lib.rans_encode(
                symbols, indexes, symbols.size,
                cdfs, cdfs.shape[1], cdf_sizes,
                self.precision, out, capacity,
            )
        if n < 0:
            raise ValueError(f"rans_encode failed with code {n}")
        return out[:n].tobytes()

    def encode_batch(
        self,
        symbols: np.ndarray,   # [N, ...] one stream per leading index
        indexes: np.ndarray,
        cdfs: np.ndarray,
        cdf_sizes: np.ndarray,
        num_threads: int = 0,
    ) -> List[bytes]:
        """Encode N independent streams in parallel C++ threads."""
        n_items = symbols.shape[0]
        symbols = np.ascontiguousarray(symbols.reshape(n_items, -1), np.int32)
        indexes = np.ascontiguousarray(indexes.reshape(n_items, -1), np.int32)
        cdfs = np.ascontiguousarray(cdfs, np.uint32)
        cdf_sizes = np.ascontiguousarray(cdf_sizes, np.int32)
        n_per = symbols.shape[1]
        capacity = n_per * 8 + 1024
        out = np.empty(n_items * capacity, np.uint8)
        sizes = np.empty(n_items, np.int64)
        if num_threads <= 0:
            num_threads = min(n_items, os.cpu_count() or 1)
        status = self._lib.rans_encode_batch(
            symbols, indexes, n_per, n_items,
            cdfs, cdfs.shape[1], cdf_sizes, self.precision,
            out, capacity, sizes, num_threads,
        )
        if status < 0:
            raise ValueError(f"rans_encode_batch failed with code {status}")
        return [
            out[i * capacity : i * capacity + sizes[i]].tobytes()
            for i in range(n_items)
        ]

    def decode_batch(
        self,
        streams: Sequence[bytes],
        indexes: np.ndarray,
        cdfs: np.ndarray,
        cdf_sizes: np.ndarray,
        num_threads: int = 0,
    ) -> np.ndarray:
        """Decode N independent streams in parallel C++ threads."""
        n_items = len(streams)
        shape = indexes.shape
        indexes = np.ascontiguousarray(indexes.reshape(n_items, -1), np.int32)
        cdfs = np.ascontiguousarray(cdfs, np.uint32)
        cdf_sizes = np.ascontiguousarray(cdf_sizes, np.int32)
        n_per = indexes.shape[1]
        sizes = np.asarray([len(s) for s in streams], np.int64)
        offsets = np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.int64)
        blob = np.frombuffer(b"".join(streams), np.uint8)
        blob = np.ascontiguousarray(blob)
        out = np.empty(n_items * n_per, np.int32)
        if num_threads <= 0:
            num_threads = min(n_items, os.cpu_count() or 1)
        status = self._lib.rans_decode_batch(
            blob, offsets, sizes, n_items,
            indexes, n_per,
            cdfs, cdfs.shape[1], cdf_sizes, self.precision,
            out, num_threads,
        )
        if status < 0:
            raise ValueError(f"rans_decode_batch failed with code {status}")
        return out.reshape(shape)

    def decode(
        self,
        data: bytes,
        indexes: np.ndarray,
        cdfs: np.ndarray,
        cdf_sizes: np.ndarray,
    ) -> np.ndarray:
        shape = indexes.shape
        indexes = np.ascontiguousarray(indexes.reshape(-1), np.int32)
        cdfs = np.ascontiguousarray(cdfs, np.uint32)
        cdf_sizes = np.ascontiguousarray(cdf_sizes, np.int32)
        buf = np.frombuffer(data, np.uint8)
        buf = np.ascontiguousarray(buf)
        out = np.empty(indexes.size, np.int32)
        n = self._lib.rans_decode(
            buf, buf.size, indexes, indexes.size,
            cdfs, cdfs.shape[1], cdf_sizes,
            self.precision, out,
        )
        if n != indexes.size:
            raise ValueError(f"rans_decode failed with code {n}")
        return out.reshape(shape)
