"""The three MPN Groth16 circuits (reference: src/mpn/circuits/).

Each has 5 public inputs [commitment, height, prev_state, aux_data,
next_state] and a fixed batch of transition slots gated by per-slot
`enabled` bits so batches pad with null transitions.

A copy of `bazuka_tpu/mpn/circuits.py`."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from ..groth16.gadgets import (
    AllocatedPoint,
    Bool,
    Num,
    UnsignedInteger,
    calc_root_poseidon4,
    check_proof_poseidon4,
    mux,
    poseidon,
    reveal,
    verify_eddsa,
)
from ..groth16.r1cs import ONE, ConstraintSystem
from .config import MpnConfig
from .deposit import deposit_aux_model
from .transitions import (
    DepositTransition,
    UpdateTransition,
    WithdrawTransition,
)
from .withdraw import withdraw_aux_model


def _alloc_proof(cs, proof):
    return [[Num.alloc(cs, s) for s in level] for level in proof]


def _inputs(cs, commitment, height, state, aux_data, next_state):
    c = Num.alloc_input(cs, commitment)
    h = Num.alloc_input(cs, height)
    s = Num.alloc_input(cs, state)
    a = Num.alloc_input(cs, aux_data)
    n = Num.alloc_input(cs, next_state)
    return c, h, s, a, n


@dataclass
class UpdateCircuit:
    """(reference: update_circuit.rs)."""

    log4_tree_size: int
    log4_token_tree_size: int
    log4_update_batch_size: int
    commitment: int = 0
    height: int = 0
    state: int = 0
    aux_data: int = 0
    next_state: int = 0
    fee_token: int = 0  # private: the accepted fee token id (as scalar)
    transitions: List[UpdateTransition] = field(default_factory=list)

    @staticmethod
    def empty(log4_tree_size, log4_token_tree_size, log4_batch_size):
        return UpdateCircuit(
            log4_tree_size, log4_token_tree_size, log4_batch_size,
            transitions=[
                UpdateTransition.null(log4_tree_size, log4_token_tree_size)
                for _ in range(1 << (2 * log4_batch_size))
            ],
        )

    def synthesize(self, cs: ConstraintSystem):
        _, _, state_wit, aux_wit, claimed_next = _inputs(
            cs, self.commitment, self.height, self.state, self.aux_data,
            self.next_state,
        )
        accepted_fee_token = Num.alloc(cs, self.fee_token)
        fee_sum = Num.zero()
        lt2 = 2 * self.log4_token_tree_size
        la2 = 2 * self.log4_tree_size

        for t in self.transitions:
            enabled = Bool.alloc(cs, t.enabled)
            src_token_index = UnsignedInteger.alloc(cs, t.src_token_index, lt2)
            src_fee_token_index = UnsignedInteger.alloc(cs, t.src_fee_token_index, lt2)
            dst_token_index = UnsignedInteger.alloc(cs, t.dst_token_index, lt2)
            src_tx_nonce = Num.alloc(cs, t.src_before.tx_nonce)
            src_withdraw_nonce = Num.alloc(cs, t.src_before.withdraw_nonce)
            src_addr = AllocatedPoint.alloc(cs, t.src_before.address)
            src_addr.assert_on_curve(cs, enabled)
            src_before_balances_hash = Num.alloc(cs, t.src_before_balances_hash)
            dst_before_balances_hash = Num.alloc(cs, t.dst_before_balances_hash)

            src_token_id = Num.alloc(cs, t.src_before_balance.token_id.scalar)
            src_balance = UnsignedInteger.alloc_64(cs, t.src_before_balance.amount)
            src_token_balance_hash = poseidon(cs, [src_token_id, src_balance.num])

            src_fee_token_id = Num.alloc(cs, t.src_before_fee_balance.token_id.scalar)
            src_fee_balance = UnsignedInteger.alloc_64(cs, t.src_before_fee_balance.amount)
            src_fee_token_balance_hash = poseidon(cs, [src_fee_token_id, src_fee_balance.num])

            src_balance_proof = _alloc_proof(cs, t.src_balance_proof)
            check_proof_poseidon4(
                cs, enabled, src_token_index, src_token_balance_hash,
                src_balance_proof, src_before_balances_hash,
            )

            tx_amount = UnsignedInteger.alloc_64(cs, t.tx.amount.amount)
            tx_fee = UnsignedInteger.alloc_64(cs, t.tx.fee.amount)

            new_token_balance_hash = poseidon(
                cs, [src_token_id, src_balance.num - tx_amount.num]
            )
            balance_middle_root = calc_root_poseidon4(
                cs, src_token_index, new_token_balance_hash, src_balance_proof
            )
            src_fee_balance_proof = _alloc_proof(cs, t.src_fee_balance_proof)
            check_proof_poseidon4(
                cs, enabled, src_fee_token_index, src_fee_token_balance_hash,
                src_fee_balance_proof, balance_middle_root,
            )
            new_fee_token_balance_hash = poseidon(
                cs, [src_fee_token_id, src_fee_balance.num - tx_fee.num]
            )
            src_balance_final_root = calc_root_poseidon4(
                cs, src_fee_token_index, new_fee_token_balance_hash,
                src_fee_balance_proof,
            )

            tx_nonce = Num.alloc(cs, t.tx.nonce)
            src_index = UnsignedInteger.alloc(cs, t.src_index, la2)
            tx_amount_token_id = Num.alloc(cs, t.tx.amount.token_id.scalar)
            tx_fee_token_id = Num.alloc(cs, t.tx.fee.token_id.scalar)

            accepted_fee_token.assert_equal_if_enabled(cs, enabled, tx_fee_token_id)
            src_token_id.assert_equal(cs, tx_amount_token_id)
            src_fee_token_id.assert_equal(cs, tx_fee_token_id)

            src_hash = poseidon(cs, [
                src_tx_nonce, src_withdraw_nonce, src_addr.x, src_addr.y,
                src_before_balances_hash,
            ])

            dst_token_id = Num.alloc(cs, t.dst_before_balance.token_id.scalar)
            dst_balance = Num.alloc(cs, t.dst_before_balance.amount)
            dst_token_balance_hash = poseidon(cs, [dst_token_id, dst_balance])
            new_dst_token_balance_hash = poseidon(
                cs, [tx_amount_token_id, dst_balance + tx_amount.num]
            )
            dst_balance_proof = _alloc_proof(cs, t.dst_balance_proof)
            check_proof_poseidon4(
                cs, enabled, dst_token_index, dst_token_balance_hash,
                dst_balance_proof, dst_before_balances_hash,
            )
            dst_balance_final_root = calc_root_poseidon4(
                cs, dst_token_index, new_dst_token_balance_hash, dst_balance_proof
            )

            src_proof = _alloc_proof(cs, t.src_proof)
            check_proof_poseidon4(
                cs, enabled, src_index, src_hash, src_proof, state_wit
            )
            new_src_hash = poseidon(cs, [
                src_tx_nonce + Num.one(), src_withdraw_nonce, src_addr.x,
                src_addr.y, src_balance_final_root,
            ])
            middle_root = calc_root_poseidon4(cs, src_index, new_src_hash, src_proof)

            tx_dst_addr = AllocatedPoint.alloc(cs, t.tx.dst_pub_key.decompress())
            tx_dst_addr.assert_on_curve(cs, enabled)
            dst_index = UnsignedInteger.alloc(cs, t.dst_index, la2)
            dst_tx_nonce = Num.alloc(cs, t.dst_before.tx_nonce)
            dst_withdraw_nonce = Num.alloc(cs, t.dst_before.withdraw_nonce)
            dst_addr = AllocatedPoint.alloc(cs, t.dst_before.address)
            dst_hash = poseidon(cs, [
                dst_tx_nonce, dst_withdraw_nonce, dst_addr.x, dst_addr.y,
                dst_before_balances_hash,
            ])
            dst_proof = _alloc_proof(cs, t.dst_proof)

            # dst slot empty or owned by tx destination
            addr_valid = dst_addr.is_null(cs).or_(
                cs, dst_addr.is_equal(cs, tx_dst_addr)
            )
            addr_valid.assert_true(cs)

            check_proof_poseidon4(
                cs, enabled, dst_index, dst_hash, dst_proof, middle_root
            )
            new_dst_hash = poseidon(cs, [
                dst_tx_nonce, dst_withdraw_nonce, tx_dst_addr.x, tx_dst_addr.y,
                dst_balance_final_root,
            ])
            next_state_wit = calc_root_poseidon4(cs, dst_index, new_dst_hash, dst_proof)
            state_wit = mux(cs, enabled, state_wit, next_state_wit)

            # amount + fee <= src balance
            amount_plus_fee = UnsignedInteger.constrain(
                cs, tx_amount.num + tx_fee.num, 64
            )
            amount_plus_fee.lte(cs, src_balance).assert_true(cs)

            # nonce chaining
            tx_nonce.assert_equal_if_enabled(
                cs, enabled, src_tx_nonce + Num.one()
            )

            final_fee = mux(cs, enabled, Num.zero(), tx_fee.num)
            fee_sum = fee_sum + final_fee

            tx_hash = poseidon(cs, [
                tx_nonce, tx_dst_addr.x, tx_dst_addr.y, tx_amount_token_id,
                tx_amount.num, tx_fee_token_id, tx_fee.num,
            ])
            sig_r = AllocatedPoint.alloc(cs, t.tx.sig.r)
            sig_r.assert_on_curve(cs, enabled)
            sig_s = Num.alloc(cs, t.tx.sig.s)
            verify_eddsa(cs, enabled, src_addr, tx_hash, sig_r, sig_s)

        fee_hash = poseidon(cs, [accepted_fee_token, fee_sum])
        aux_wit.assert_equal(cs, fee_hash)
        state_wit.assert_equal(cs, claimed_next)


@dataclass
class DepositCircuit:
    """(reference: deposit_circuit.rs)."""

    log4_tree_size: int
    log4_token_tree_size: int
    log4_deposit_batch_size: int
    commitment: int = 0
    height: int = 0
    state: int = 0
    aux_data: int = 0
    next_state: int = 0
    transitions: List[DepositTransition] = field(default_factory=list)

    @staticmethod
    def empty(log4_tree_size, log4_token_tree_size, log4_batch_size):
        return DepositCircuit(
            log4_tree_size, log4_token_tree_size, log4_batch_size,
            transitions=[
                DepositTransition.null(log4_tree_size, log4_token_tree_size)
                for _ in range(1 << (2 * log4_batch_size))
            ],
        )

    def synthesize(self, cs: ConstraintSystem):
        _, _, state_wit, aux_wit, claimed_next = _inputs(
            cs, self.commitment, self.height, self.state, self.aux_data,
            self.next_state,
        )
        lt2 = 2 * self.log4_token_tree_size
        la2 = 2 * self.log4_tree_size

        # reveal the deposit tx list committed in aux_data
        tx_wits = []
        children = []
        for t in self.transitions:
            enabled = Bool.alloc(cs, t.enabled)
            token_id = Num.alloc(cs, t.tx.payment.amount.token_id.scalar)
            amount = UnsignedInteger.alloc_64(cs, t.tx.payment.amount.amount)
            pub_key = AllocatedPoint.alloc(cs, t.tx.mpn_address.decompress())
            tx_wits.append((enabled, token_id, amount, pub_key))
            pub_key_hash = poseidon(cs, [pub_key.x, pub_key.y])
            calldata = mux(cs, enabled, Num.zero(), pub_key_hash)
            children.append([enabled.num, token_id, amount.num, calldata])
        tx_root = reveal(cs, deposit_aux_model(self.log4_deposit_batch_size), children)
        aux_wit.assert_equal(cs, tx_root)

        for t, (enabled, tx_token_id, tx_amount, tx_pub_key) in zip(
            self.transitions, tx_wits
        ):
            tx_index = UnsignedInteger.alloc(cs, t.account_index, la2)
            tx_token_index = UnsignedInteger.alloc(cs, t.token_index, lt2)
            tx_pub_key.assert_on_curve(cs, enabled)
            src_tx_nonce = Num.alloc(cs, t.before.tx_nonce)
            src_withdraw_nonce = Num.alloc(cs, t.before.withdraw_nonce)
            src_addr = AllocatedPoint.alloc(cs, t.before.address)
            src_balances_hash = Num.alloc(cs, t.before_balances_hash)
            src_token_id = Num.alloc(cs, t.before_balance.token_id.scalar)
            src_balance = Num.alloc(cs, t.before_balance.amount)
            src_token_balance_hash = poseidon(cs, [src_token_id, src_balance])
            balance_proof = _alloc_proof(cs, t.balance_proof)
            check_proof_poseidon4(
                cs, enabled, tx_token_index, src_token_balance_hash,
                balance_proof, src_balances_hash,
            )
            src_hash = poseidon(cs, [
                src_tx_nonce, src_withdraw_nonce, src_addr.x, src_addr.y,
                src_balances_hash,
            ])
            proof = _alloc_proof(cs, t.proof)

            # slot token empty or matching
            token_valid = src_token_id.is_zero(cs).or_(
                cs, src_token_id.is_equal(cs, tx_token_id)
            )
            token_valid.assert_true(cs)
            # slot address empty or matching
            addr_valid = src_addr.is_null(cs).or_(
                cs, src_addr.is_equal(cs, tx_pub_key)
            )
            addr_valid.assert_true(cs)

            check_proof_poseidon4(cs, enabled, tx_index, src_hash, proof, state_wit)

            new_balances_hash = poseidon(cs, [tx_token_id, src_balance + tx_amount.num])
            new_balances_root = calc_root_poseidon4(
                cs, tx_token_index, new_balances_hash, balance_proof
            )
            new_hash = poseidon(cs, [
                src_tx_nonce, src_withdraw_nonce, tx_pub_key.x, tx_pub_key.y,
                new_balances_root,
            ])
            next_state_wit = calc_root_poseidon4(cs, tx_index, new_hash, proof)
            state_wit = mux(cs, enabled, state_wit, next_state_wit)

        state_wit.assert_equal(cs, claimed_next)


@dataclass
class WithdrawCircuit:
    """(reference: withdraw_circuit.rs)."""

    log4_tree_size: int
    log4_token_tree_size: int
    log4_withdraw_batch_size: int
    commitment: int = 0
    height: int = 0
    state: int = 0
    aux_data: int = 0
    next_state: int = 0
    transitions: List[WithdrawTransition] = field(default_factory=list)

    @staticmethod
    def empty(log4_tree_size, log4_token_tree_size, log4_batch_size):
        return WithdrawCircuit(
            log4_tree_size, log4_token_tree_size, log4_batch_size,
            transitions=[
                WithdrawTransition.null(log4_tree_size, log4_token_tree_size)
                for _ in range(1 << (2 * log4_batch_size))
            ],
        )

    def synthesize(self, cs: ConstraintSystem):
        _, _, state_wit, aux_wit, claimed_next = _inputs(
            cs, self.commitment, self.height, self.state, self.aux_data,
            self.next_state,
        )
        lt2 = 2 * self.log4_token_tree_size
        la2 = 2 * self.log4_tree_size

        tx_wits = []
        children = []
        for t in self.transitions:
            enabled = Bool.alloc(cs, t.enabled)
            amount_token_id = Num.alloc(cs, t.tx.payment.amount.token_id.scalar)
            amount = UnsignedInteger.alloc_64(cs, t.tx.payment.amount.amount)
            fee_token_id = Num.alloc(cs, t.tx.payment.fee.token_id.scalar)
            fee = UnsignedInteger.alloc_64(cs, t.tx.payment.fee.amount)
            fingerprint = Num.alloc(
                cs, t.tx.payment.fingerprint() if t.enabled else 0
            )
            pub_key = AllocatedPoint.alloc(cs, t.tx.mpn_address.decompress())
            nonce = Num.alloc(cs, t.tx.mpn_withdraw_nonce)
            sig_r = AllocatedPoint.alloc(cs, t.tx.mpn_sig.r)
            sig_s = Num.alloc(cs, t.tx.mpn_sig.s)
            tx_wits.append(
                (enabled, amount_token_id, amount, fee_token_id, fee,
                 fingerprint, pub_key, nonce, sig_r, sig_s)
            )
            calldata_hash = poseidon(cs, [
                pub_key.x, pub_key.y, nonce, sig_r.x, sig_r.y, sig_s,
            ])
            calldata = mux(cs, enabled, Num.zero(), calldata_hash)
            children.append([
                enabled.num, amount_token_id, amount.num, fee_token_id,
                fee.num, fingerprint, calldata,
            ])
        tx_root = reveal(cs, withdraw_aux_model(self.log4_withdraw_batch_size), children)
        aux_wit.assert_equal(cs, tx_root)

        for t, (enabled, tx_amount_token_id, tx_amount, tx_fee_token_id,
                tx_fee, fingerprint, tx_pub_key, tx_nonce, sig_r, sig_s) in zip(
            self.transitions, tx_wits
        ):
            tx_index = UnsignedInteger.alloc(cs, t.account_index, la2)
            tx_token_index = UnsignedInteger.alloc(cs, t.token_index, lt2)
            tx_fee_token_index = UnsignedInteger.alloc(cs, t.fee_token_index, lt2)
            tx_pub_key.assert_on_curve(cs, enabled)

            tx_hash = poseidon(cs, [fingerprint, tx_nonce])
            sig_r.assert_on_curve(cs, enabled)
            verify_eddsa(cs, enabled, tx_pub_key, tx_hash, sig_r, sig_s)

            src_tx_nonce = Num.alloc(cs, t.before.tx_nonce)
            src_withdraw_nonce = Num.alloc(cs, t.before.withdraw_nonce)
            src_addr = AllocatedPoint.alloc(cs, t.before.address)
            src_addr.assert_on_curve(cs, enabled)

            before_token_hash = Num.alloc(cs, t.before_token_hash)
            src_token_id = Num.alloc(cs, t.before_token_balance.token_id.scalar)
            src_token_id.assert_equal(cs, tx_amount_token_id)
            src_balance = Num.alloc(cs, t.before_token_balance.amount)
            src_token_balance_hash = poseidon(cs, [src_token_id, src_balance])
            token_balance_proof = _alloc_proof(cs, t.token_balance_proof)
            check_proof_poseidon4(
                cs, enabled, tx_token_index, src_token_balance_hash,
                token_balance_proof, before_token_hash,
            )
            new_token_balance_hash = poseidon(
                cs, [src_token_id, src_balance - tx_amount.num]
            )
            balance_middle_root = calc_root_poseidon4(
                cs, tx_token_index, new_token_balance_hash, token_balance_proof
            )

            src_fee_token_id = Num.alloc(cs, t.before_fee_balance.token_id.scalar)
            src_fee_token_id.assert_equal(cs, tx_fee_token_id)
            src_fee_balance = Num.alloc(cs, t.before_fee_balance.amount)
            src_fee_token_balance_hash = poseidon(
                cs, [src_fee_token_id, src_fee_balance]
            )
            fee_balance_proof = _alloc_proof(cs, t.fee_balance_proof)
            check_proof_poseidon4(
                cs, enabled, tx_fee_token_index, src_fee_token_balance_hash,
                fee_balance_proof, balance_middle_root,
            )
            new_fee_token_balance_hash = poseidon(
                cs, [src_fee_token_id, src_fee_balance - tx_fee.num]
            )

            src_hash = poseidon(cs, [
                src_tx_nonce, src_withdraw_nonce, src_addr.x, src_addr.y,
                before_token_hash,
            ])
            proof = _alloc_proof(cs, t.proof)
            check_proof_poseidon4(cs, enabled, tx_index, src_hash, proof, state_wit)

            # withdraw-nonce chaining
            tx_nonce.assert_equal_if_enabled(
                cs, enabled, src_withdraw_nonce + Num.one()
            )

            balance_final_root = calc_root_poseidon4(
                cs, tx_fee_token_index, new_fee_token_balance_hash, fee_balance_proof
            )
            new_hash = poseidon(cs, [
                src_tx_nonce, src_withdraw_nonce + Num.one(), tx_pub_key.x,
                tx_pub_key.y, balance_final_root,
            ])
            next_state_wit = calc_root_poseidon4(cs, tx_index, new_hash, proof)
            state_wit = mux(cs, enabled, state_wit, next_state_wit)

        state_wit.assert_equal(cs, claimed_next)


def synthesize_circuit(circuit, proving: bool = True) -> ConstraintSystem:
    cs = ConstraintSystem(proving=proving)
    circuit.synthesize(cs)
    return cs
