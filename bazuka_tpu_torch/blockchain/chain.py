"""The prover commitment of `bazuka_tpu/blockchain/chain.py`, the one part
of the chain engine the MPN proving path needs."""

from __future__ import annotations

from ..core.hash import Sha3Hasher
from ..crypto.ed25519 import PublicKey as Address
from ..fields.host import fr_from_le_bytes_mod


def prover_commitment(prover: Address, reward: int) -> int:
    """The 5th Groth16 public input: SHA3(prover ‖ reward) -> Fr
    (reference: src/mpn/mod.rs:281-295)."""
    return fr_from_le_bytes_mod(
        Sha3Hasher.hash(prover.raw + int(reward).to_bytes(8, "little"))
    )
