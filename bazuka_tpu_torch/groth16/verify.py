"""Groth16 verification (host pairings).

Checks e(A, B) = e(α, β) · e(Σ xᵢ ICᵢ, γ) · e(C, δ) as a single
multi-pairing product == 1 (reference: src/zk/groth16/mod.rs:67-121
delegates to bellman's verify_proof; same equation).

A copy of `bazuka_tpu/groth16/verify.py`."""

from __future__ import annotations

from typing import List

from ..crypto import bls12_381 as bls
from ..fields import tower as tw
from ..zk.proof import Groth16Proof, Groth16VerifyingKey
from .keygen import wire_g1, wire_g2


def groth16_verify(
    vk: Groth16VerifyingKey, public_inputs: List[int], proof: Groth16Proof
) -> bool:
    if len(public_inputs) + 1 != len(vk.ic):
        return False
    a = wire_g1(proof.a)
    b = wire_g2(proof.b)
    c = wire_g1(proof.c)
    # points must be on-curve AND in the prime-order subgroup (wire
    # values are untrusted; BLS12-381 cofactors admit small-order
    # components, and bellman enforces subgroup checks at
    # deserialization — matching that closes proof malleability)
    for p in (a, c):
        if not bls.g1_is_on_curve(p) or not bls.g1_in_subgroup(p):
            return False
    if not bls.g2_is_on_curve(b) or not bls.g2_in_subgroup(b):
        return False
    ic_sum = wire_g1(vk.ic[0])
    for x, icw in zip(public_inputs, vk.ic[1:]):
        ic_sum = bls.g1_add(ic_sum, bls.g1_mul(wire_g1(icw), x % bls.R))
    out = bls.multi_pairing(
        [
            (a, b),
            (bls.g1_neg(wire_g1(vk.alpha_g1)), wire_g2(vk.beta_g2)),
            (bls.g1_neg(ic_sum), wire_g2(vk.gamma_g2)),
            (bls.g1_neg(c), wire_g2(vk.delta_g2)),
        ]
    )
    return out == tw.FP12_ONE
