"""Proof / verifier-key wire types and the proof-check dispatch.

Mirrors the reference's wire formats (reference: src/zk/groth16/mod.rs:19-38)
with honest field-element integers instead of memory transmutes: G1 points
are (x, y, infinity) over Fp, G2 points are ((x0,x1), (y0,y1), infinity)
over Fp2.  `check_proof` dispatches Groth16 vs the `Dummy` test variant
(reference: src/zk/mod.rs:157-193).
A copy of `bazuka_tpu/zk/proof.py`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..utils import ser

FP_BYTES = 48


# ---------------------------------------------------------------- points


@dataclass(frozen=True)
class G1Wire:
    x: int
    y: int
    infinity: bool = False

    def write_to(self, w: ser.Writer):
        w.big(self.x, FP_BYTES).big(self.y, FP_BYTES).boolean(self.infinity)

    @staticmethod
    def read_from(r: ser.Reader) -> "G1Wire":
        return G1Wire(r.big(FP_BYTES), r.big(FP_BYTES), r.boolean())


@dataclass(frozen=True)
class G2Wire:
    x: Tuple[int, int]  # Fp2 = x0 + x1*u
    y: Tuple[int, int]
    infinity: bool = False

    def write_to(self, w: ser.Writer):
        w.big(self.x[0], FP_BYTES).big(self.x[1], FP_BYTES)
        w.big(self.y[0], FP_BYTES).big(self.y[1], FP_BYTES)
        w.boolean(self.infinity)

    @staticmethod
    def read_from(r: ser.Reader) -> "G2Wire":
        x = (r.big(FP_BYTES), r.big(FP_BYTES))
        y = (r.big(FP_BYTES), r.big(FP_BYTES))
        return G2Wire(x, y, r.boolean())


# ---------------------------------------------------------------- groth16


@dataclass
class Groth16VerifyingKey:
    alpha_g1: G1Wire
    beta_g1: G1Wire
    beta_g2: G2Wire
    gamma_g2: G2Wire
    delta_g1: G1Wire
    delta_g2: G2Wire
    ic: List[G1Wire] = field(default_factory=list)

    def write_to(self, w: ser.Writer):
        for p in (self.alpha_g1, self.beta_g1):
            p.write_to(w)
        self.beta_g2.write_to(w)
        self.gamma_g2.write_to(w)
        self.delta_g1.write_to(w)
        self.delta_g2.write_to(w)
        w.seq(self.ic, lambda w, p: p.write_to(w))

    @staticmethod
    def read_from(r: ser.Reader) -> "Groth16VerifyingKey":
        alpha_g1 = G1Wire.read_from(r)
        beta_g1 = G1Wire.read_from(r)
        beta_g2 = G2Wire.read_from(r)
        gamma_g2 = G2Wire.read_from(r)
        delta_g1 = G1Wire.read_from(r)
        delta_g2 = G2Wire.read_from(r)
        ic = r.seq(G1Wire.read_from)
        return Groth16VerifyingKey(
            alpha_g1, beta_g1, beta_g2, gamma_g2, delta_g1, delta_g2, ic
        )


@dataclass
class Groth16Proof:
    a: G1Wire
    b: G2Wire
    c: G1Wire

    def write_to(self, w: ser.Writer):
        self.a.write_to(w)
        self.b.write_to(w)
        self.c.write_to(w)

    @staticmethod
    def read_from(r: ser.Reader) -> "Groth16Proof":
        return Groth16Proof(G1Wire.read_from(r), G2Wire.read_from(r), G1Wire.read_from(r))


# ---------------------------------------------------------------- enums


@dataclass(frozen=True)
class ZkVerifierKey:
    """Groth16 VK or the Dummy test variant."""

    kind: str  # "groth16" | "dummy"
    vk: Optional[Groth16VerifyingKey] = None

    @staticmethod
    def groth16(vk: Groth16VerifyingKey) -> "ZkVerifierKey":
        return ZkVerifierKey("groth16", vk)

    @staticmethod
    def dummy() -> "ZkVerifierKey":
        return ZkVerifierKey("dummy")

    def write_to(self, w: ser.Writer):
        if self.kind == "groth16":
            w.variant(0)
            self.vk.write_to(w)
        else:
            w.variant(1)

    @staticmethod
    def read_from(r: ser.Reader) -> "ZkVerifierKey":
        v = r.variant()
        if v == 0:
            return ZkVerifierKey.groth16(Groth16VerifyingKey.read_from(r))
        if v == 1:
            return ZkVerifierKey.dummy()
        raise ValueError(f"bad verifier key tag {v}")


@dataclass(frozen=True)
class ZkProof:
    kind: str  # "groth16" | "dummy"
    proof: Optional[Groth16Proof] = None
    ok: bool = True  # dummy verdict

    @staticmethod
    def groth16(proof: Groth16Proof) -> "ZkProof":
        return ZkProof("groth16", proof)

    @staticmethod
    def dummy(ok: bool = True) -> "ZkProof":
        return ZkProof("dummy", None, ok)

    def write_to(self, w: ser.Writer):
        if self.kind == "groth16":
            w.variant(0)
            self.proof.write_to(w)
        else:
            w.variant(1)
            w.boolean(self.ok)

    @staticmethod
    def read_from(r: ser.Reader) -> "ZkProof":
        v = r.variant()
        if v == 0:
            return ZkProof.groth16(Groth16Proof.read_from(r))
        if v == 1:
            return ZkProof.dummy(r.boolean())
        raise ValueError(f"bad proof tag {v}")


@dataclass(frozen=True)
class ZkMultiInputVerifierKey:
    verifier_key: ZkVerifierKey
    log4_payment_capacity: int


@dataclass(frozen=True)
class ZkSingleInputVerifierKey:
    verifier_key: ZkVerifierKey


@dataclass
class ZkTokenContract:
    token: object  # core.token.Token
    mint_functions: List[ZkSingleInputVerifierKey] = field(default_factory=list)


def write_multi_vk(w: ser.Writer, vk: ZkMultiInputVerifierKey):
    vk.verifier_key.write_to(w)
    w.u8(vk.log4_payment_capacity)


def read_multi_vk(r: ser.Reader) -> ZkMultiInputVerifierKey:
    return ZkMultiInputVerifierKey(ZkVerifierKey.read_from(r), r.u8())


def write_single_vk(w: ser.Writer, vk: ZkSingleInputVerifierKey):
    vk.verifier_key.write_to(w)


def read_single_vk(r: ser.Reader) -> ZkSingleInputVerifierKey:
    return ZkSingleInputVerifierKey(ZkVerifierKey.read_from(r))


def write_token_contract(w: ser.Writer, tc: ZkTokenContract):
    tc.token.write_to(w)
    w.seq(tc.mint_functions, write_single_vk)


def read_token_contract(r: ser.Reader) -> ZkTokenContract:
    from ..core.token import Token

    return ZkTokenContract(Token.read_from(r), r.seq(read_single_vk))


# ---------------------------------------------------------------- dispatch

# The reference compiles the Dummy VK/proof variants only under
# #[cfg(test)] (src/zk/mod.rs:184-191) — on a real chain a dummy proof
# must never verify.  Python has no cfg(test), so the test configs flip
# this flag explicitly; it is off by default.
_ALLOW_DUMMY = False


def allow_dummy_proofs(flag: bool = True):
    global _ALLOW_DUMMY
    _ALLOW_DUMMY = flag


def check_proof(
    vk: ZkVerifierKey,
    commitment: int,
    prev_height: int,
    prev_state: int,
    aux_data: int,
    next_state: int,
    proof: ZkProof,
) -> bool:
    """Verify against the 5 public inputs
    [commitment, height, prev_state, aux_data, next_state]
    (reference: src/zk/mod.rs:157-193, src/zk/groth16/mod.rs:67-121)."""
    if vk.kind == "groth16":
        if proof.kind != "groth16":
            return False
        from ..groth16.verify import groth16_verify

        return groth16_verify(
            vk.vk,
            [commitment, prev_height, prev_state, aux_data, next_state],
            proof.proof,
        )
    if vk.kind == "dummy":
        return _ALLOW_DUMMY and proof.kind == "dummy" and proof.ok
    return False
