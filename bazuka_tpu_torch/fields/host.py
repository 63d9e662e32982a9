"""Host-side (pure Python int) prime-field arithmetic and BLS12-381 field
constants.

A copy of `bazuka_tpu/fields/host.py`: the port imports nothing of the JAX
package.  Mirrors the reference's `ff`-derived fields (reference:
src/zk/mod.rs:202-206 for Fr, src/zk/groth16/mod.rs:19-20 for Fp).
"""

from __future__ import annotations

from dataclasses import dataclass

# BLS12-381 scalar field modulus (reference: src/zk/mod.rs:196-199)
FR_MODULUS = int(
    "52435875175126190479447740508185965837690552500527637822603658699938581184513"
)

# BLS12-381 base field modulus (381 bits)
FP_MODULUS = int(
    "0x1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eabfffeb153"
    "ffffb9feffffffffaaab",
    16,
)

# JubJub subgroup order (reference: src/crypto/jubjub/curve.rs:160-163)
JUBJUB_ORDER = int(
    "6554484396890773809930967563523245729705921265872317281365359162392183254199"
)

# Multiplicative generator of Fr (reference: src/zk/mod.rs:204 PrimeFieldGenerator=7)
FR_GENERATOR = 7
# Fr has 2-adicity 32: FR_MODULUS - 1 = 2^32 * t
FR_TWO_ADICITY = 32


@dataclass(frozen=True)
class HostField:
    """Arithmetic mod p on Python ints."""

    p: int

    def add(self, a: int, b: int) -> int:
        return (a + b) % self.p

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.p

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.p

    def sqr(self, a: int) -> int:
        return (a * a) % self.p

    def neg(self, a: int) -> int:
        return (-a) % self.p

    def inv(self, a: int) -> int:
        if a % self.p == 0:
            raise ZeroDivisionError("inverse of zero")
        return pow(a, -1, self.p)

    def pow(self, a: int, e: int) -> int:
        return pow(a, e, self.p)

    def sqrt(self, a: int):
        """Tonelli-Shanks square root; returns None if non-residue."""
        p = self.p
        a %= p
        if a == 0:
            return 0
        if pow(a, (p - 1) // 2, p) != 1:
            return None
        if p % 4 == 3:
            return pow(a, (p + 1) // 4, p)
        # general Tonelli-Shanks
        q, s = p - 1, 0
        while q % 2 == 0:
            q //= 2
            s += 1
        z = 2
        while pow(z, (p - 1) // 2, p) != p - 1:
            z += 1
        m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
        while t != 1:
            i, t2 = 0, t
            while t2 != 1:
                t2 = t2 * t2 % p
                i += 1
            b = pow(c, 1 << (m - i - 1), p)
            m, c = i, b * b % p
            t = t * c % p
            r = r * b % p
        return r

    def is_odd(self, a: int) -> bool:
        """Parity of the canonical representative (ff's `is_odd`)."""
        return (a % self.p) & 1 == 1


FR = HostField(FR_MODULUS)


def fr_from_le_bytes_mod(data: bytes) -> int:
    """ZkScalar::new semantics: little-endian bytes reduced mod p
    (reference: src/zk/mod.rs:262-271)."""
    return int.from_bytes(data, "little") % FR_MODULUS


def fr_to_le_bytes(x: int) -> bytes:
    """Canonical 32-byte little-endian repr (ff to_repr, little endianness)."""
    return (x % FR_MODULUS).to_bytes(32, "little")


def fr_to_hex(x: int) -> str:
    """Display format `0x<64 hex, big-endian>` (reference: src/zk/mod.rs:222-233)."""
    return "0x" + fr_to_le_bytes(x)[::-1].hex()


def fr_from_hex(s: str) -> int:
    """Parse the display format; rejects non-canonical values
    (reference: src/zk/mod.rs:241-260)."""
    if not s.startswith("0x"):
        raise ValueError("scalar invalid")
    raw = bytes.fromhex(s[2:])
    if len(raw) != 32:
        raise ValueError("scalar invalid")
    v = int.from_bytes(raw, "big")
    if v >= FR_MODULUS:
        raise ValueError("scalar invalid")
    return v
