"""Block headers & PoS consensus data (reference: src/core/header.rs).
A copy of `bazuka_tpu/core/header.py`."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..crypto.ed25519 import PublicKey as Address
from ..crypto.vrf import Output as VrfOutput, Proof as VrfProof
from ..utils import ser
from .hash import Sha3Hasher
from .transaction import read_address, write_address


@dataclass
class ValidatorProof:
    """VRF leader-election proof (reference: header.rs:5-16)."""

    attempt: int
    vrf_output: VrfOutput
    vrf_proof: VrfProof

    def power(self) -> float:
        return 1.0 / (self.attempt + 1.0)

    def write_to(self, w: ser.Writer):
        w.u32(self.attempt)
        w.bytes(self.vrf_output.to_bytes())
        w.bytes(self.vrf_proof.to_bytes())

    @staticmethod
    def read_from(r: ser.Reader) -> "ValidatorProof":
        attempt = r.u32()
        out_b = r.bytes()
        proof_b = r.bytes()
        from ..crypto import jubjub as jj

        x = int.from_bytes(out_b[:32], "little")
        sign = bool(out_b[32])
        return ValidatorProof(
            attempt, VrfOutput(jj.decompress((x, sign))), VrfProof.from_bytes(proof_b)
        )


@dataclass
class ProofOfStake:
    validator: Address
    timestamp: int
    proof: Optional[ValidatorProof] = None

    def power(self) -> float:
        return self.proof.power() if self.proof else 0.0

    def write_to(self, w: ser.Writer):
        write_address(w, self.validator)
        w.u32(self.timestamp)
        w.option(self.proof, lambda w, p: p.write_to(w))

    @staticmethod
    def read_from(r: ser.Reader) -> "ProofOfStake":
        return ProofOfStake(
            read_address(r), r.u32(), r.option(ValidatorProof.read_from)
        )


@dataclass
class Header:
    parent_hash: bytes
    number: int
    block_root: bytes
    proof_of_stake: ProofOfStake

    def write_to(self, w: ser.Writer):
        w.raw(self.parent_hash)
        w.u64(self.number)
        w.raw(self.block_root)
        self.proof_of_stake.write_to(w)

    @staticmethod
    def read_from(r: ser.Reader) -> "Header":
        return Header(r.raw(32), r.u64(), r.raw(32), ProofOfStake.read_from(r))

    def hash(self) -> bytes:
        return Sha3Hasher.hash(ser.dumps(self))
