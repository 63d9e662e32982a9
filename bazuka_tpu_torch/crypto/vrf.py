"""Verifiable random function for PoS leader election.

Fills the role of the reference's schnorrkel sr25519 VRF
(reference: src/crypto/vrf.rs) with a self-contained ECVRF over JubJub:
  output O = a·H2C(msg), proof = Chaum-Pedersen DLEQ (R1=k·B, R2=k·Hm,
  c = H(inputs), s = k + c·a mod ORDER).
Deterministic k (derived from sk and message) — no RNG dependence.
The float mapping Output -> [0,1) feeds the stake-weighted election
(reference: src/blockchain/mod.rs:564-604).
A copy of `bazuka_tpu/crypto/vrf.py`.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Tuple

from . import jubjub as jj

CONTEXT = b"ZieshaVRF"


@dataclass(frozen=True)
class PublicKey:
    point: Tuple[int, int]

    def __str__(self) -> str:
        x, sign = jj.compress(self.point)
        return f"vrf{int(sign)}{x.to_bytes(32, 'little')[::-1].hex()}"

    @staticmethod
    def parse(s: str) -> "PublicKey":
        if len(s) != 68 or not s.startswith("vrf") or s[3] not in "01":
            raise ValueError("vrf public key invalid")
        x = int.from_bytes(bytes.fromhex(s[4:]), "big")
        return PublicKey(jj.decompress((x, s[3] == "1")))


@dataclass(frozen=True)
class PrivateKey:
    scalar: int
    public: Tuple[int, int]


@dataclass(frozen=True)
class Proof:
    c: int
    s: int

    def to_bytes(self) -> bytes:
        return self.c.to_bytes(32, "little") + self.s.to_bytes(32, "little")

    @staticmethod
    def from_bytes(b: bytes) -> "Proof":
        return Proof(
            int.from_bytes(b[:32], "little"), int.from_bytes(b[32:64], "little")
        )


@dataclass(frozen=True)
class Output:
    point: Tuple[int, int]

    def to_bytes(self) -> bytes:
        x, sign = jj.compress(self.point)
        return x.to_bytes(32, "little") + bytes([int(sign)])

    def as_float(self) -> float:
        """Uniform [0, 1) from the output point (election threshold)."""
        h = hashlib.sha3_256(b"vrf-float" + self.to_bytes()).digest()
        return int.from_bytes(h[:8], "little") / float(1 << 64)


def _hash_to_curve(message: bytes) -> Tuple[int, int]:
    """Try-and-increment x-coordinates, cofactor-cleared into the subgroup."""
    ctr = 0
    while True:
        x = jj.hash_to_scalar(b"vrf-h2c" + CONTEXT + message + ctr.to_bytes(4, "little"))
        try:
            p = jj.decompress((x, False))
        except ValueError:
            ctr += 1
            continue
        p8 = jj.point_mul(p, 8)
        if p8 != jj.ZERO:
            return p8


def _challenge(*points: Tuple[int, int]) -> int:
    h = hashlib.sha3_256()
    h.update(b"vrf-dleq" + CONTEXT)
    for p in points:
        x, sign = jj.compress(p)
        h.update(x.to_bytes(32, "little") + bytes([int(sign)]))
    return int.from_bytes(h.digest(), "little") % jj.ORDER


class VRF:
    @staticmethod
    def generate_keys(seed: bytes):
        a = jj.hash_to_scalar(b"vrf-key" + seed) % jj.ORDER
        if a == 0:
            a = 1
        pub = jj.point_mul(jj.BASE, a)
        return PublicKey(pub), PrivateKey(a, pub)

    @staticmethod
    def sign(sk: PrivateKey, message: bytes) -> Tuple[Output, Proof]:
        hm = _hash_to_curve(message)
        o = jj.point_mul(hm, sk.scalar)
        k = (
            jj.hash_to_scalar(
                b"vrf-nonce" + sk.scalar.to_bytes(32, "little") + message
            )
            % jj.ORDER
        ) or 1
        r1 = jj.point_mul(jj.BASE, k)
        r2 = jj.point_mul(hm, k)
        c = _challenge(sk.public, hm, o, r1, r2)
        s = (k + c * sk.scalar) % jj.ORDER
        return Output(o), Proof(c, s)

    @staticmethod
    def verify(pk: PublicKey, message: bytes, out: Output, proof: Proof) -> bool:
        if not jj.is_on_curve(pk.point) or not jj.is_on_curve(out.point):
            return False
        # Prime-order-subgroup membership: JubJub has cofactor 8, so a
        # torsion-shifted output O+T would otherwise also pass the DLEQ
        # check, giving a staker multiple valid outputs per slot (output
        # uniqueness is what the reference's sr25519 VRF guarantees).
        for p in (pk.point, out.point):
            if jj.point_mul(p, jj.ORDER) != jj.ZERO:
                return False
        hm = _hash_to_curve(message)
        c, s = proof.c % jj.ORDER, proof.s % jj.ORDER
        # R1 = s·B − c·A ;  R2 = s·Hm − c·O
        r1 = jj.point_add(
            jj.point_mul(jj.BASE, s), jj.point_neg(jj.point_mul(pk.point, c))
        )
        r2 = jj.point_add(
            jj.point_mul(hm, s), jj.point_neg(jj.point_mul(out.point, c))
        )
        return _challenge(pk.point, hm, out.point, r1, r2) == c
