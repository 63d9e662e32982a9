"""Proof and verifying-key wire types (the Groth16 part of
`bazuka_tpu/zk/proof.py`).

G1 points are (x, y, infinity) over Fp, G2 points ((x0,x1), (y0,y1),
infinity) over Fp2 (reference: src/zk/groth16/mod.rs:19-38)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

from ..utils import ser

FP_BYTES = 48


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
        return Groth16Proof(G1Wire.read_from(r), G2Wire.read_from(r),
                            G1Wire.read_from(r))
