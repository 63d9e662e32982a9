"""Reference-compatible Groth16 wire codec (bincode + Montgomery limbs).

The reference serializes VKs/proofs by memory-transmuting bls12_381
affine points into `(Fp, Fp, bool)` tuples of RAW INTERNAL Montgomery
limbs and bincoding those (reference: src/zk/groth16/mod.rs:19-38,
40-66; bincode legacy config = fixed-width little-endian integers,
u64 sequence lengths).  An Fp is 6 little-endian u64 limbs holding
value*2^384 mod p; a G2 coordinate is (c0, c1) with c0 + c1*u.

This module converts between that byte format and our canonical-int
`Groth16VerifyingKey`/`Groth16Proof` wire types, so reference-produced
artifacts — e.g. the hardcoded mainnet MPN ceremony VKs at
src/config/blockchain.rs:31-38 — load and verify here unchanged.
A copy of `bazuka_tpu/zk/wire.py`.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

from ..fields.host import FP_MODULUS
from .proof import G1Wire, G2Wire, Groth16Proof, Groth16VerifyingKey

P = FP_MODULUS
R384 = pow(2, 384, P)
R384_INV = pow(R384, -1, P)


class WireFormatError(ValueError):
    pass


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def take(self, n: int) -> bytes:
        if self.off + n > len(self.data):
            raise WireFormatError("truncated wire data")
        out = self.data[self.off : self.off + n]
        self.off += n
        return out

    def fp(self) -> int:
        """6 LE u64 Montgomery limbs -> canonical int < p."""
        limbs = struct.unpack("<6Q", self.take(48))
        raw = sum(l << (64 * i) for i, l in enumerate(limbs))
        if raw >= P:
            raise WireFormatError("Fp limbs not reduced")
        return raw * R384_INV % P

    def boolean(self) -> bool:
        b = self.take(1)[0]
        if b not in (0, 1):
            raise WireFormatError("bad bool byte")
        return b == 1

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def g1(self) -> G1Wire:
        x, y, inf = self.fp(), self.fp(), self.boolean()
        return G1Wire(0, 1, True) if inf else G1Wire(x, y, False)

    def g2(self) -> G2Wire:
        x = (self.fp(), self.fp())
        y = (self.fp(), self.fp())
        inf = self.boolean()
        return G2Wire((0, 0), (1, 0), True) if inf else G2Wire(x, y, False)


class _Writer:
    def __init__(self):
        self.parts: List[bytes] = []

    def fp(self, v: int):
        raw = v % P * R384 % P
        self.parts.append(
            struct.pack("<6Q", *[(raw >> (64 * i)) & (2**64 - 1) for i in range(6)])
        )

    def boolean(self, b: bool):
        self.parts.append(bytes([1 if b else 0]))

    def u64(self, v: int):
        self.parts.append(struct.pack("<Q", v))

    def g1(self, w: G1Wire):
        # the reference transmutes whatever limbs the point struct holds;
        # bellman's identity is encoded with its internal (0, 1) coords
        if w.infinity:
            self.fp(0), self.fp(1), self.boolean(True)
        else:
            self.fp(w.x), self.fp(w.y), self.boolean(False)

    def g2(self, w: G2Wire):
        if w.infinity:
            for v in (0, 0, 1, 0):
                self.fp(v)
            self.boolean(True)
        else:
            for v in (*w.x, *w.y):
                self.fp(v)
            self.boolean(False)

    def bytes(self) -> bytes:
        return b"".join(self.parts)


def decode_vk(data: bytes) -> Groth16VerifyingKey:
    r = _Reader(data)
    vk = Groth16VerifyingKey(
        alpha_g1=r.g1(),
        beta_g1=r.g1(),
        beta_g2=r.g2(),
        gamma_g2=r.g2(),
        delta_g1=r.g1(),
        delta_g2=r.g2(),
        ic=[],
    )
    n = r.u64()
    if n > 1 << 16:
        raise WireFormatError("unreasonable ic length")
    vk.ic.extend(r.g1() for _ in range(n))
    if r.off != len(data):
        raise WireFormatError("trailing bytes after VK")
    return vk


def encode_vk(vk: Groth16VerifyingKey) -> bytes:
    w = _Writer()
    w.g1(vk.alpha_g1)
    w.g1(vk.beta_g1)
    w.g2(vk.beta_g2)
    w.g2(vk.gamma_g2)
    w.g1(vk.delta_g1)
    w.g2(vk.delta_g2)
    w.u64(len(vk.ic))
    for p in vk.ic:
        w.g1(p)
    return w.bytes()


def decode_proof(data: bytes) -> Groth16Proof:
    r = _Reader(data)
    proof = Groth16Proof(a=r.g1(), b=r.g2(), c=r.g1())
    if r.off != len(data):
        raise WireFormatError("trailing bytes after proof")
    return proof


def encode_proof(p: Groth16Proof) -> bytes:
    w = _Writer()
    w.g1(p.a)
    w.g2(p.b)
    w.g1(p.c)
    return w.bytes()


def validate_vk_points(vk: Groth16VerifyingKey) -> Optional[str]:
    """On-curve + prime-order-subgroup check of every VK point.  Returns
    an error string or None (VKs arrive in untrusted contract-creation
    txs; bellman validates on deserialize, so must we)."""
    from ..crypto import bls12_381 as bls
    from ..groth16.keygen import wire_g1, wire_g2

    g1s = [("alpha_g1", vk.alpha_g1), ("beta_g1", vk.beta_g1), ("delta_g1", vk.delta_g1)]
    g1s += [(f"ic[{i}]", p) for i, p in enumerate(vk.ic)]
    for name, w in g1s:
        p = wire_g1(w)
        if not bls.g1_is_on_curve(p):
            return f"{name} not on curve"
        if not bls.g1_in_subgroup(p):
            return f"{name} not in subgroup"
    for name, w in (
        ("beta_g2", vk.beta_g2),
        ("gamma_g2", vk.gamma_g2),
        ("delta_g2", vk.delta_g2),
    ):
        p = wire_g2(w)
        if not bls.g2_is_on_curve(p):
            return f"{name} not on curve"
        if not bls.g2_in_subgroup(p):
            return f"{name} not in subgroup"
    return None
