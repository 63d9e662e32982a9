"""MPN rollup configuration (reference: src/mpn/mod.rs:202-241).

A copy of `bazuka_tpu/mpn/config.py`."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from ..core.transaction import ContractId
from ..zk.proof import ZkVerifierKey
from ..zk.state import SCALAR, ListModel, Struct


@dataclass
class MpnConfig:
    log4_tree_size: int
    log4_token_tree_size: int
    log4_deposit_batch_size: int
    log4_withdraw_batch_size: int
    log4_update_batch_size: int
    mpn_contract_id: ContractId
    mpn_num_update_batches: int = 1
    mpn_num_deposit_batches: int = 1
    mpn_num_withdraw_batches: int = 1
    deposit_vk: ZkVerifierKey = None
    withdraw_vk: ZkVerifierKey = None
    update_vk: ZkVerifierKey = None

    def state_model(self):
        """Account tree: List4^n[Struct[tx_nonce, withdraw_nonce, pub_x,
        pub_y, List4^t[Struct[token_id, balance]]]]."""
        return ListModel(
            self.log4_tree_size,
            Struct([
                SCALAR, SCALAR, SCALAR, SCALAR,
                ListModel(self.log4_token_tree_size, Struct([SCALAR, SCALAR])),
            ]),
        )


@dataclass(frozen=True)
class ZkPublicInputs:
    """The four chain-side public values; the fifth Groth16 input is the
    prover-reward commitment (reference: src/mpn/mod.rs:250-256, 281-295)."""

    height: int
    state: int
    aux_data: int
    next_state: int

    def as_list(self) -> Tuple[int, ...]:
        return (self.height, self.state, self.aux_data, self.next_state)
