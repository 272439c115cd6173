"""Self-contained bitstream container (tfc.PackedTensors capability; a copy
of nic_tpu/coding/container.py, so the two packages read each other's files).

The reference packs [string, side_string, x/y/z spatial shapes] into one
.tfci file (mbt2018.py:211-221, 252-260). Format here ("NTC1"):

  magic   4 bytes  b"NTC1"
  hlen    4 bytes  uint32 little-endian, JSON header length
  header  JSON: {"streams": [name, ...], "lengths": [...], "ints": {...}}
  payload concatenated raw streams

Integers (shapes etc.) travel in the JSON header; byte streams in the
payload. Self-contained given the runname — exactly the property the
reference's decompress path relies on (SURVEY.md section 3.5).
"""

import json
import struct
from typing import Dict, List

_MAGIC = b"NTC1"


class PackedBitstream:
    def __init__(self):
        self._streams: Dict[str, bytes] = {}
        self._ints: Dict[str, List[int]] = {}

    def add_stream(self, name: str, data: bytes):
        self._streams[name] = bytes(data)

    def add_ints(self, name: str, values):
        self._ints[name] = [int(v) for v in values]

    def get_stream(self, name: str) -> bytes:
        return self._streams[name]

    def get_ints(self, name: str) -> List[int]:
        return self._ints[name]

    def has_ints(self, name: str) -> bool:
        return name in self._ints

    # ------------------------------------------------------------------ io

    def pack(self) -> bytes:
        names = sorted(self._streams)
        header = json.dumps(
            {
                "streams": names,
                "lengths": [len(self._streams[n]) for n in names],
                "ints": self._ints,
            }
        ).encode("utf-8")
        out = bytearray()
        out += _MAGIC
        out += struct.pack("<I", len(header))
        out += header
        for n in names:
            out += self._streams[n]
        return bytes(out)

    @classmethod
    def unpack(cls, data: bytes) -> "PackedBitstream":
        if data[:4] != _MAGIC:
            raise ValueError("Not a NTC1 bitstream")
        (hlen,) = struct.unpack("<I", data[4:8])
        header = json.loads(data[8 : 8 + hlen].decode("utf-8"))
        obj = cls()
        obj._ints = {k: list(v) for k, v in header["ints"].items()}
        pos = 8 + hlen
        for name, length in zip(header["streams"], header["lengths"]):
            obj._streams[name] = data[pos : pos + length]
            pos += length
        return obj
