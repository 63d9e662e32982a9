"""JubJub twisted-Edwards curve over BLS12-381 Fr + Poseidon-EdDSA.

A copy of `bazuka_tpu/crypto/jubjub.py` (host Python ints).

Curve: a*x^2 + y^2 = 1 + d*x^2*y^2 with a = -1,
d = 19257...7233, cofactor 8, subgroup order ORDER
(reference: src/crypto/jubjub/curve.rs:146-164).

EdDSA (Poseidon-flavored, reference: src/crypto/jubjub/mod.rs:108-168):
  sign:   r = H(randomness, M); R = r*B; h = H(R.x, R.y, A.x, A.y, M);
          s = (r + h*a) mod ORDER
  verify: s*B == R + h*A   (subgroup points; cofactor handled in-circuit)
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional, Tuple

from ..fields.host import FR, FR_MODULUS, JUBJUB_ORDER
from ..zk.poseidon_host import PoseidonHasher

P = FR_MODULUS
A = P - 1  # a = -1
D = 19257038036680949359750312669786877991949435402254120286184196891950884077233

BASE = (
    28867639725710769449342053336011988556061781325688749245863888315629457631946,
    18,
)
ORDER = JUBJUB_ORDER
COFACTOR = 8


def hash_to_scalar(data: bytes) -> int:
    """SHA3-256 -> Fr, little-endian mod-reduce (reference: src/zk/mod.rs:218-220)."""
    return int.from_bytes(hashlib.sha3_256(data).digest(), "little") % P


# ---------------------------------------------------------------- points
# Affine points are (x, y) int tuples; identity is (0, 1).

ZERO = (0, 1)


def is_on_curve(p: Tuple[int, int]) -> bool:
    x, y = p
    return (y * y - x * x) % P == (1 + D * x * x % P * y * y) % P


def point_add(p: Tuple[int, int], q: Tuple[int, int]) -> Tuple[int, int]:
    """Unified twisted-Edwards affine addition (doubles when p == q,
    matching reference: src/crypto/jubjub/curve.rs:19-36)."""
    if p == q:
        return point_double(p)
    x1, y1 = p
    x2, y2 = q
    dxy = D * x1 % P * x2 % P * y1 % P * y2 % P
    x3 = (x1 * y2 + y1 * x2) % P * FR.inv((1 + dxy) % P) % P
    y3 = (y1 * y2 - A * x1 % P * x2) % P * FR.inv((1 - dxy) % P) % P
    return (x3, y3)


def point_double(p: Tuple[int, int]) -> Tuple[int, int]:
    x, y = p
    axx = A * x % P * x % P
    yy = y * y % P
    x3 = 2 * x * y % P * FR.inv((axx + yy) % P) % P
    y3 = (yy - axx) % P * FR.inv((2 - axx - yy) % P) % P
    return (x3, y3)


def point_neg(p: Tuple[int, int]) -> Tuple[int, int]:
    x, y = p
    return ((-x) % P, y)


def point_mul(p: Tuple[int, int], scalar: int) -> Tuple[int, int]:
    """Double-and-add over the fixed 255-bit little-endian scalar repr
    (reference: src/crypto/jubjub/curve.rs:58-68).  Uses extended
    projective internally for speed; output is affine."""
    result = _PROJ_ZERO
    base = (p[0], p[1], 1)
    bits = scalar % P
    for i in range(254, -1, -1):
        result = _proj_double(result)
        if (bits >> i) & 1:
            result = _proj_add(result, base)
    return _proj_to_affine(result)


# projective (x, y, z): affine = (x/z, y/z)
_PROJ_ZERO = (0, 1, 0)


def _proj_is_zero(p) -> bool:
    return p[2] == 0


def _proj_add(p, q):
    if _proj_is_zero(p):
        return q
    if _proj_is_zero(q):
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    a = z1 * z2 % P
    b = a * a % P
    c = x1 * x2 % P
    d = y1 * y2 % P
    e = D * c % P * d % P
    f = (b - e) % P
    g = (b + e) % P
    if f == 0 or g == 0:
        # same or opposite point; fall back to doubling / identity
        ax1, ay1 = _proj_to_affine(p)
        ax2, ay2 = _proj_to_affine(q)
        if (ax1, ay1) == (ax2, ay2):
            return _proj_double(p)
        return _PROJ_ZERO
    x3 = a * f % P * (((x1 + y1) * (x2 + y2) - c - d) % P) % P
    y3 = a * g % P * ((d - A * c) % P) % P
    z3 = f * g % P
    return (x3, y3, z3)


def _proj_double(p):
    if _proj_is_zero(p):
        return _PROJ_ZERO
    x, y, z = p
    b = (x + y) * (x + y) % P
    c = x * x % P
    d = y * y % P
    e = A * c % P
    f = (e + d) % P
    h = z * z % P
    j = (f - 2 * h) % P
    return ((b - c - d) * j % P, f * (e - d) % P, f * j % P)


def _proj_to_affine(p) -> Tuple[int, int]:
    if _proj_is_zero(p):
        return ZERO
    zinv = FR.inv(p[2])
    return (p[0] * zinv % P, p[1] * zinv % P)


BASE_COFACTOR = point_mul(BASE, 8)


# ---------------------------------------------------------------- compression


def compress(p: Tuple[int, int]) -> Tuple[int, bool]:
    """(x, sign) with sign = parity of y (reference: curve.rs:70-74)."""
    return (p[0], FR.is_odd(p[1]))


def decompress(c: Tuple[int, bool]) -> Tuple[int, int]:
    x, sign = c
    xx = x * x % P
    y2 = (1 - A * xx) % P * FR.inv((1 - D * xx) % P) % P
    y = FR.sqrt(y2)
    if y is None:
        raise ValueError("invalid compressed point")
    if FR.is_odd(y) != sign:
        y = (-y) % P
    return (x, y)


# ---------------------------------------------------------------- keys & sigs


@dataclass(frozen=True)
class PublicKey:
    """Compressed public key; displays as `jub2<hex>`/`jub3<hex>`
    (reference: src/crypto/jubjub/mod.rs:60-106)."""

    x: int
    sign: bool

    def decompress(self) -> Tuple[int, int]:
        return decompress((self.x, self.sign))

    def is_on_curve(self) -> bool:
        try:
            return is_on_curve(self.decompress())
        except ValueError:
            return False

    def __str__(self) -> str:
        return f"jub{3 if self.sign else 2}{self.x.to_bytes(32, 'little')[::-1].hex()}"

    @staticmethod
    def parse(s: str) -> "PublicKey":
        if len(s) != 68:
            raise ValueError("public key invalid")
        if s.startswith("jub3"):
            sign = True
        elif s.startswith("jub2"):
            sign = False
        else:
            raise ValueError("public key invalid")
        v = int.from_bytes(bytes.fromhex(s[4:]), "big")
        if v >= P:
            raise ValueError("public key invalid")
        return PublicKey(v, sign)


@dataclass(frozen=True)
class PrivateKey:
    public_point: Tuple[int, int]
    randomness: int
    scalar: int


@dataclass(frozen=True)
class Signature:
    r: Tuple[int, int]  # affine point
    s: int


class JubJub:
    """ZkSignatureScheme: Poseidon-EdDSA on JubJub."""

    hasher = PoseidonHasher

    @classmethod
    def generate_keys(cls, seed: bytes) -> Tuple[PublicKey, PrivateKey]:
        randomness = hash_to_scalar(seed)
        scalar = hash_to_scalar(randomness.to_bytes(32, "little"))
        point = point_mul(BASE, scalar)
        pub = PublicKey(*compress(point))
        return pub, PrivateKey(point, randomness, scalar)

    @classmethod
    def sign(cls, sk: PrivateKey, message: int) -> Signature:
        H = cls.hasher.hash
        r = H([sk.randomness, message])
        rr = point_mul(BASE, r)
        h = H([rr[0], rr[1], sk.public_point[0], sk.public_point[1], message])
        s = (r + h * sk.scalar) % ORDER
        return Signature(rr, s)

    @classmethod
    def verify(cls, pk: PublicKey, message: int, sig: Signature) -> bool:
        try:
            pkp = pk.decompress()
        except ValueError:
            return False
        if not is_on_curve(pkp) or not is_on_curve(sig.r):
            return False
        H = cls.hasher.hash
        h = H([sig.r[0], sig.r[1], pkp[0], pkp[1], message])
        sb = point_mul(BASE, sig.s)
        r_plus_ha = point_add(point_mul(pkp, h), sig.r)
        return r_plus_ha == sb
