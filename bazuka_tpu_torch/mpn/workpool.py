"""MPN work pool — validator-side distributed-proving coordinator
(reference: src/mpn/mod.rs:63-424).

`prepare_works` builds the deposit/withdraw/update batches (prepending
the validator's reward self-deposit), `get_works` assigns jobs to
registered workers, `prove` verifies incoming Groth16 solutions against
the prover-reward commitment, and `ready` assembles the final
UpdateContract transaction with all proofs + the state delta.
A copy of `bazuka_tpu/mpn/workpool.py`.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..core.transaction import (
    ContractId,
    ContractUpdate,
    ContractUpdateData,
    Money,
    MpnDeposit,
    MpnTransaction,
    MpnWithdraw,
    Transaction,
    TransactionAndDelta,
    TransactionData,
)
from ..crypto.ed25519 import PublicKey as Address
from ..db import Put, Remove, keys
from ..zk.proof import ZkProof, ZkVerifierKey, check_proof
from ..zk.state import ZkCompressedState, blob_to_scalar, loc_parse, u64_to_blob
from . import deposit as dep_mod
from . import update as upd_mod
from . import withdraw as wd_mod
from .chain_view import MpnChainView
from .config import MpnConfig, ZkPublicInputs


def extract_delta(ops) -> Dict[Tuple[int, ...], Optional[int]]:
    """Write ops on scalar state keys -> delta pairs
    (reference: src/mpn/mod.rs:33-56)."""
    pairs: Dict[Tuple[int, ...], Optional[int]] = {}
    for op in ops:
        key = op.key
        parts = key.split("-S-")
        if len(parts) < 2:
            continue
        loc = loc_parse(parts[1])
        if isinstance(op, Put):
            pairs[loc] = blob_to_scalar(op.value)
        else:
            pairs[loc] = None
    return pairs


@dataclass
class MpnWorker:
    address: Address


@dataclass
class MpnWork:
    config: MpnConfig
    public_inputs: ZkPublicInputs
    data_kind: str  # "deposit" | "withdraw" | "update"
    transitions: List
    new_root: ZkCompressedState
    reward: int

    def vk(self) -> ZkVerifierKey:
        return {
            "deposit": self.config.deposit_vk,
            "withdraw": self.config.withdraw_vk,
            "update": self.config.update_vk,
        }[self.data_kind]

    def verify(self, prover: Address, proof: ZkProof) -> bool:
        """(reference: src/mpn/mod.rs:281-295)."""
        from ..blockchain.chain import prover_commitment

        return check_proof(
            self.vk(),
            prover_commitment(prover, self.reward),
            self.public_inputs.height,
            self.public_inputs.state,
            self.public_inputs.aux_data,
            self.public_inputs.next_state,
            proof,
        )


@dataclass
class MpnSolution:
    prover: Address
    proof: ZkProof


class MpnWorkPool:
    """(reference: src/mpn/mod.rs:63-200)."""

    def __init__(self, config: MpnConfig, works: List[MpnWork], final_delta):
        self.config = config
        self.works: Dict[int, MpnWork] = dict(enumerate(works))
        self.final_delta = final_delta
        self.solutions: Dict[int, MpnSolution] = {}
        self.assignees: Dict[str, List[int]] = {}

    def remaining_works(self) -> Dict[int, MpnWork]:
        return {i: w for i, w in self.works.items() if i not in self.solutions}

    def get_works(self, address: Address) -> Dict[int, MpnWork]:
        """Assign up to 2 random unassigned works per worker."""
        key = str(address)
        if key in self.assignees:
            selected = self.assignees[key]
        else:
            taken = {wid for ids in self.assignees.values() for wid in ids}
            not_assigned = [
                i for i in self.remaining_works() if i not in taken
            ]
            selected = random.sample(not_assigned, min(2, len(not_assigned)))
            self.assignees[key] = selected
        return {i: self.works[i] for i in selected if i in self.works}

    def prove(self, work_id: int, prover: Address, proof: ZkProof) -> bool:
        if work_id in self.solutions or work_id not in self.works:
            return False
        if not self.works[work_id].verify(prover, proof):
            return False
        self.solutions[work_id] = MpnSolution(prover, proof)
        return True

    def ready(self, tx_builder, nonce: int) -> Optional[TransactionAndDelta]:
        """Assemble the UpdateContract tx once every work is proven
        (reference: src/mpn/mod.rs:130-199)."""
        if len(self.works) != len(self.solutions):
            return None
        updates = []
        for i in range(len(self.works)):
            work = self.works[i]
            sol = self.solutions[i]
            if work.data_kind == "deposit":
                data = ContractUpdateData(
                    "deposit",
                    deposits=[t.tx.payment for t in work.transitions],
                )
            elif work.data_kind == "withdraw":
                data = ContractUpdateData(
                    "withdraw",
                    withdraws=[t.tx.payment for t in work.transitions],
                )
            else:
                fee_sum = sum(t.tx.fee.amount for t in work.transitions)
                data = ContractUpdateData(
                    "function_call", fee=Money.ziesha(fee_sum)
                )
            updates.append(
                ContractUpdate(
                    circuit_id=0,
                    data=data,
                    next_state=work.new_root,
                    prover=sol.prover,
                    reward=work.reward,
                    proof=sol.proof,
                )
            )
        tx = Transaction(
            src=tx_builder.get_address(),
            nonce=nonce,
            data=TransactionData(
                "update_contract",
                contract_id=self.config.mpn_contract_id,
                updates=updates,
                delta=dict(self.final_delta),
            ),
            fee=Money.ziesha(0),
            memo="",
        )
        tx_builder.sign_tx(tx)
        return TransactionAndDelta(tx, dict(self.final_delta))


def prepare_works(
    config: MpnConfig,
    chain,
    workers: Dict[str, MpnWorker],
    deposits: List[MpnDeposit],
    withdraws: List[MpnWithdraw],
    updates: List[MpnTransaction],
    block_reward: int,
    deposit_reward: int,
    withdraw_reward: int,
    update_reward: int,
    validator_deposit_nonce: int,
    validator_tx_builder,
    user_tx_builder,
) -> MpnWorkPool:
    """Build the block's proof workload on a RAM fork
    (reference: src/mpn/mod.rs:296-424)."""
    fork = chain.fork_on_ram()
    view = MpnChainView(fork.db)
    # chain-backed index/count/balance lookups through the fork
    view.get_mpn_account_indices = fork.get_mpn_account_indices
    view.get_mpn_account_count = fork.get_mpn_account_count
    view.get_balance = fork.get_balance

    worker_list = list(workers.values()) or [MpnWorker(user_tx_builder.get_address())]
    new_account_indices = {}
    works: List[MpnWork] = []

    remaining_reward = (
        block_reward
        - config.mpn_num_deposit_batches * deposit_reward
        - config.mpn_num_withdraw_batches * withdraw_reward
        - config.mpn_num_update_batches * update_reward
    )

    validator_balance = chain.get_balance(
        validator_tx_builder.get_address(), ContractId.ZIESHA
    )
    fork.db.update(
        [
            Put(
                keys.account_balance(
                    str(validator_tx_builder.get_address()), str(ContractId.ZIESHA)
                ),
                u64_to_blob(validator_balance + remaining_reward),
            )
        ]
    )
    # validator's reward self-deposit rides the first deposit batch
    deposits = [
        validator_tx_builder.deposit_mpn(
            "",
            config.mpn_contract_id,
            validator_tx_builder.get_mpn_address(),
            validator_deposit_nonce + 1,
            Money.ziesha(remaining_reward),
            Money.ziesha(0),
        )
    ] + list(deposits)

    for _ in range(config.mpn_num_deposit_batches):
        new_root, pubs, transitions = dep_mod.deposit(
            config.mpn_contract_id, config.log4_tree_size,
            config.log4_token_tree_size, config.log4_deposit_batch_size,
            view, deposits, new_account_indices, check_balance=True,
        )
        works.append(MpnWork(config, pubs, "deposit", transitions, new_root, deposit_reward))
    for _ in range(config.mpn_num_withdraw_batches):
        new_root, pubs, transitions = wd_mod.withdraw(
            config.mpn_contract_id, config.log4_tree_size,
            config.log4_token_tree_size, config.log4_withdraw_batch_size,
            view, withdraws, new_account_indices,
        )
        works.append(MpnWork(config, pubs, "withdraw", transitions, new_root, withdraw_reward))
    for _ in range(config.mpn_num_update_batches):
        new_root, pubs, transitions = upd_mod.update(
            config.mpn_contract_id, config.log4_tree_size,
            config.log4_token_tree_size, config.log4_update_batch_size,
            ContractId.ZIESHA, view, updates, new_account_indices,
        )
        works.append(MpnWork(config, pubs, "update", transitions, new_root, update_reward))

    final_delta = extract_delta(fork.db.to_ops())
    return MpnWorkPool(config, works, final_delta)
