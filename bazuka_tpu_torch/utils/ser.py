"""Deterministic binary serialization (bincode-flavored) — the part of
`bazuka_tpu/utils/ser.py` that the proof and key wire types need.

  * u8/u64: little-endian fixed width
  * bool: single byte 0/1
  * big: fixed-width little-endian big integer
  * list: u64 LE count + items
"""

from __future__ import annotations

import io
import struct


class Writer:
    def __init__(self):
        self._buf = io.BytesIO()

    def u8(self, v: int):
        self._buf.write(struct.pack("<B", v))
        return self

    def u64(self, v: int):
        self._buf.write(struct.pack("<Q", v))
        return self

    def big(self, v: int, nbytes: int):
        """Fixed-width little-endian big integer (e.g. 48-byte Fp)."""
        self._buf.write(int(v).to_bytes(nbytes, "little"))
        return self

    def boolean(self, v: bool):
        return self.u8(1 if v else 0)

    def seq(self, items, write_item):
        self.u64(len(items))
        for it in items:
            write_item(self, it)
        return self

    def getvalue(self) -> bytes:
        return self._buf.getvalue()


class Reader:
    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0

    def _take(self, n: int) -> bytes:
        if self._pos + n > len(self._data):
            raise ValueError("serialization underrun")
        b = self._data[self._pos : self._pos + n]
        self._pos += n
        return b

    def u8(self) -> int:
        return struct.unpack("<B", self._take(1))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def big(self, nbytes: int) -> int:
        return int.from_bytes(self._take(nbytes), "little")

    def boolean(self) -> bool:
        return self.u8() != 0

    def seq(self, read_item) -> list:
        return [read_item(self) for _ in range(self.u64())]

    def expect_done(self):
        if self._pos != len(self._data):
            raise ValueError("trailing bytes in serialized value")


def dumps(obj) -> bytes:
    """Serialize any object exposing `write_to(writer)`."""
    w = Writer()
    obj.write_to(w)
    return w.getvalue()


def loads(cls, data: bytes):
    """Deserialize via `cls.read_from(reader)`, requiring full consumption."""
    r = Reader(data)
    out = cls.read_from(r)
    r.expect_done()
    return out
