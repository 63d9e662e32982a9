"""Deterministic binary serialization (bincode-flavored).

A copy of `bazuka_tpu/utils/ser.py`.

The reference serializes every stored blob and every peer-to-peer message
with bincode (fixed little-endian ints, u64 length prefixes; reference:
src/db/mod.rs:307-312 checksum, src/client/mod.rs bincode transport).
This is our equivalent wire/storage codec: deterministic, versionless,
schema-driven by the calling type's `write_to`/`read_from`.

Primitives:
  * u8/u16/u32/u64/u128: little-endian fixed width
  * bool: single byte 0/1
  * bytes/str: u64 LE length prefix + raw data
  * list: u64 LE count + items
  * option: u8 tag (0=None, 1=Some)
  * enum variant: u32 LE variant index
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

    def u16(self, v: int):
        self._buf.write(struct.pack("<H", v))
        return self

    def u32(self, v: int):
        self._buf.write(struct.pack("<I", v))
        return self

    def u64(self, v: int):
        self._buf.write(struct.pack("<Q", v))
        return self

    def u128(self, v: int):
        self._buf.write(int(v).to_bytes(16, "little"))
        return self

    def big(self, v: int, nbytes: int):
        """Fixed-width little-endian big integer (e.g. 32-byte Fr repr)."""
        self._buf.write(int(v).to_bytes(nbytes, "little"))
        return self

    def boolean(self, v: bool):
        return self.u8(1 if v else 0)

    def raw(self, b: bytes):
        self._buf.write(b)
        return self

    def bytes(self, b: bytes):
        self.u64(len(b))
        self._buf.write(b)
        return self

    def string(self, s: str):
        return self.bytes(s.encode("utf-8"))

    def option(self, v, write_item):
        if v is None:
            return self.u8(0)
        self.u8(1)
        write_item(self, v)
        return self

    def seq(self, items, write_item):
        self.u64(len(items))
        for it in items:
            write_item(self, it)
        return self

    def variant(self, idx: int):
        return self.u32(idx)

    def obj(self, o):
        """Serialize an object exposing `write_to(writer)`."""
        o.write_to(self)
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

    def u16(self) -> int:
        return struct.unpack("<H", self._take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def u128(self) -> int:
        return int.from_bytes(self._take(16), "little")

    def big(self, nbytes: int) -> int:
        return int.from_bytes(self._take(nbytes), "little")

    def boolean(self) -> bool:
        return self.u8() != 0

    def raw(self, n: int) -> bytes:
        return self._take(n)

    def bytes(self) -> bytes:
        return self._take(self.u64())

    def string(self) -> str:
        return self.bytes().decode("utf-8")

    def option(self, read_item):
        return read_item(self) if self.u8() else None

    def seq(self, read_item) -> list:
        return [read_item(self) for _ in range(self.u64())]

    def variant(self) -> int:
        return self.u32()

    def done(self) -> bool:
        return self._pos == len(self._data)

    def expect_done(self):
        if not self.done():
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
