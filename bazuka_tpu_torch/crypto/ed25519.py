"""Ed25519 L1 signature scheme (reference: src/crypto/ed25519.rs), in pure
Python after RFC 8032 §5.1 (Ed25519) on `hashlib` alone.

The JAX package's `bazuka_tpu/crypto/ed25519.py` calls the `cryptography`
package; this module gives the same public keys and the same signature
bytes (Ed25519 is deterministic) and depends on nothing outside the
standard library.  Key derivation matches the reference's: secret =
SHA3(seed) with the top byte masked to 0x7f (reference:
src/crypto/ed25519.rs:70-78).  Addresses display as `ed<64 hex>` with
byte-reversed key material (reference: :86-95).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional, Tuple

# RFC 8032 §5.1: the field, the curve constant d, the group order L and
# the base point B = (x, 4/5) with x even
_Q = 2**255 - 19
_D = -121665 * pow(121666, -1, _Q) % _Q
_L = 2**252 + 27742317777372353535851937790883648493
_SQRT_M1 = pow(2, (_Q - 1) // 4, _Q)
_BY = 4 * pow(5, -1, _Q) % _Q

# extended homogeneous coordinates (X, Y, Z, T): x = X/Z, y = Y/Z, xy = T/Z
_Point = Tuple[int, int, int, int]
_IDENTITY: _Point = (0, 1, 1, 0)


def _add(p: _Point, q: _Point) -> _Point:
    """RFC 8032 §5.1.4; complete on edwards25519, so it also doubles."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % _Q
    b = (y1 + x1) * (y2 + x2) % _Q
    c = 2 * t1 * t2 * _D % _Q
    d = 2 * z1 * z2 % _Q
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % _Q, g * h % _Q, f * g % _Q, e * h % _Q)


def _mul(s: int, p: _Point) -> _Point:
    q = _IDENTITY
    while s > 0:
        if s & 1:
            q = _add(q, p)
        p = _add(p, p)
        s >>= 1
    return q


def _encode(p: _Point) -> bytes:
    x, y, z, _ = p
    zi = pow(z, -1, _Q)
    x, y = x * zi % _Q, y * zi % _Q
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _recover_x(y: int, sign: int) -> Optional[int]:
    """RFC 8032 §5.1.3 steps 2-4: x from y and x's low bit, or None."""
    if y >= _Q:
        return None
    u = (y * y - 1) % _Q
    v = (_D * y * y + 1) % _Q
    x = u * pow(v, 3, _Q) * pow(u * pow(v, 7, _Q), (_Q - 5) // 8, _Q) % _Q
    vxx = v * x * x % _Q
    if vxx == (-u) % _Q:
        x = x * _SQRT_M1 % _Q
    elif vxx != u:
        return None
    if x == 0 and sign:
        return None
    if x & 1 != sign:
        x = _Q - x
    return x


def _decode(raw: bytes) -> Optional[_Point]:
    if len(raw) != 32:
        return None
    n = int.from_bytes(raw, "little")
    y = n & ((1 << 255) - 1)
    x = _recover_x(y, n >> 255)
    if x is None:
        return None
    return (x, y, 1, x * y % _Q)


_B: _Point = _decode(_BY.to_bytes(32, "little"))


def _sha512_int(*parts: bytes) -> int:
    return int.from_bytes(hashlib.sha512(b"".join(parts)).digest(), "little")


def _expand(secret: bytes) -> Tuple[int, bytes]:
    """RFC 8032 §5.1.5: the clamped scalar and the signing prefix."""
    h = hashlib.sha512(secret).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


@dataclass(frozen=True)
class PublicKey:
    raw: bytes  # 32 bytes

    def __str__(self) -> str:
        return "ed" + self.raw[::-1].hex()

    @staticmethod
    def parse(s: str) -> "PublicKey":
        if len(s) != 66 or not s.lower().startswith("ed"):
            raise ValueError("public key invalid")
        raw = bytes.fromhex(s[2:])[::-1]
        if _decode(raw) is None:  # validate the point
            raise ValueError("public key invalid")
        return PublicKey(raw)


@dataclass(frozen=True)
class PrivateKey:
    raw: bytes  # 32-byte seed

    @property
    def public(self) -> PublicKey:
        a, _ = _expand(self.raw)
        return PublicKey(_encode(_mul(a, _B)))


ZERO_SIG = bytes(64)


class Ed25519:
    """SignatureScheme: generate_keys / sign / verify over raw bytes."""

    @staticmethod
    def generate_keys(seed: bytes):
        secret = bytearray(hashlib.sha3_256(seed).digest())
        secret[31] &= 0x7F
        sk = PrivateKey(bytes(secret))
        return sk.public, sk

    @staticmethod
    def sign(sk: PrivateKey, message: bytes) -> bytes:
        """RFC 8032 §5.1.6."""
        a, prefix = _expand(sk.raw)
        pub = _encode(_mul(a, _B))
        r = _sha512_int(prefix, message) % _L
        rr = _encode(_mul(r, _B))
        k = _sha512_int(rr, pub, message) % _L
        return rr + ((r + k * a) % _L).to_bytes(32, "little")

    @staticmethod
    def verify(pk: PublicKey, message: bytes, sig: bytes) -> bool:
        """RFC 8032 §5.1.7 without the cofactor: the encoding of
        [S]B − [k]A must equal R's bytes."""
        if len(sig) != 64:
            return False
        a = _decode(pk.raw)
        s = int.from_bytes(sig[32:], "little")
        if a is None or s >= _L:
            return False
        k = _sha512_int(sig[:32], pk.raw, message) % _L
        neg_a = ((-a[0]) % _Q, a[1], a[2], (-a[3]) % _Q)
        return _encode(_add(_mul(s, _B), _mul(k, neg_a))) == sig[:32]
