"""Per-tx transition records: the circuit witnesses
(reference: src/mpn/mod.rs:426-537).  `null()` pads fixed-shape batches.

A copy of `bazuka_tpu/mpn/transitions.py`."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

from ..core.transaction import (
    ContractDeposit,
    ContractId,
    ContractWithdraw,
    Money,
    MpnDeposit,
    MpnTransaction,
    MpnWithdraw,
)
from ..crypto import jubjub as jj
from .account import MpnAccount

ZERO3 = (0, 0, 0)


def _null_proof(levels: int) -> List[Tuple[int, int, int]]:
    return [ZERO3] * levels


def _null_jub_pub() -> jj.PublicKey:
    return jj.PublicKey(0, False)


def _null_sig() -> jj.Signature:
    return jj.Signature((0, 1), 0)


def null_mpn_transaction() -> MpnTransaction:
    return MpnTransaction(
        nonce=0, src_pub_key=_null_jub_pub(), dst_pub_key=_null_jub_pub(),
        amount=Money(ContractId.NULL, 0), fee=Money(ContractId.NULL, 0),
        sig=_null_sig(),
    )


def null_mpn_deposit() -> MpnDeposit:
    from ..crypto.ed25519 import PublicKey

    return MpnDeposit(
        mpn_address=_null_jub_pub(),
        payment=ContractDeposit(
            memo="", contract_id=ContractId.NULL, deposit_circuit_id=0,
            calldata=0, src=PublicKey(bytes(32)),
            amount=Money(ContractId.NULL, 0), fee=Money(ContractId.NULL, 0),
            nonce=0,
        ),
    )


def null_mpn_withdraw() -> MpnWithdraw:
    from ..crypto.ed25519 import PublicKey

    return MpnWithdraw(
        mpn_address=_null_jub_pub(), mpn_withdraw_nonce=0, mpn_sig=_null_sig(),
        payment=ContractWithdraw(
            memo="", contract_id=ContractId.NULL, withdraw_circuit_id=0,
            calldata=0, dst=PublicKey(bytes(32)),
            amount=Money(ContractId.NULL, 0), fee=Money(ContractId.NULL, 0),
        ),
    )


@dataclass
class DepositTransition:
    enabled: bool
    tx: MpnDeposit
    before: MpnAccount
    before_balances_hash: int
    before_balance: Money
    proof: List[Tuple[int, int, int]]
    account_index: int
    token_index: int
    balance_proof: List[Tuple[int, int, int]]

    @staticmethod
    def null(log4_tree_size: int, log4_token_tree_size: int) -> "DepositTransition":
        return DepositTransition(
            enabled=False, tx=null_mpn_deposit(), before=MpnAccount(),
            before_balances_hash=0, before_balance=Money(ContractId.NULL, 0),
            proof=_null_proof(log4_tree_size), account_index=0, token_index=0,
            balance_proof=_null_proof(log4_token_tree_size),
        )


@dataclass
class WithdrawTransition:
    enabled: bool
    tx: MpnWithdraw
    before: MpnAccount
    before_token_balance: Money
    before_fee_balance: Money
    proof: List[Tuple[int, int, int]]
    account_index: int
    token_index: int
    token_balance_proof: List[Tuple[int, int, int]]
    before_token_hash: int
    fee_token_index: int
    fee_balance_proof: List[Tuple[int, int, int]]

    @staticmethod
    def null(log4_tree_size: int, log4_token_tree_size: int) -> "WithdrawTransition":
        return WithdrawTransition(
            enabled=False, tx=null_mpn_withdraw(), before=MpnAccount(),
            before_token_balance=Money(ContractId.NULL, 0),
            before_fee_balance=Money(ContractId.NULL, 0),
            proof=_null_proof(log4_tree_size), account_index=0, token_index=0,
            token_balance_proof=_null_proof(log4_token_tree_size),
            before_token_hash=0, fee_token_index=0,
            fee_balance_proof=_null_proof(log4_token_tree_size),
        )


@dataclass
class UpdateTransition:
    enabled: bool
    tx: MpnTransaction
    src_before: MpnAccount
    src_before_balances_hash: int
    src_before_balance: Money
    src_before_fee_balance: Money
    src_proof: List[Tuple[int, int, int]]
    src_index: int
    src_token_index: int
    src_balance_proof: List[Tuple[int, int, int]]
    src_fee_token_index: int
    src_fee_balance_proof: List[Tuple[int, int, int]]
    dst_before: MpnAccount
    dst_before_balances_hash: int
    dst_before_balance: Money
    dst_proof: List[Tuple[int, int, int]]
    dst_index: int
    dst_token_index: int
    dst_balance_proof: List[Tuple[int, int, int]]

    @staticmethod
    def null(log4_tree_size: int, log4_token_tree_size: int) -> "UpdateTransition":
        return UpdateTransition(
            enabled=False, tx=null_mpn_transaction(), src_before=MpnAccount(),
            src_before_balances_hash=0,
            src_before_balance=Money(ContractId.NULL, 0),
            src_before_fee_balance=Money(ContractId.NULL, 0),
            src_proof=_null_proof(log4_tree_size), src_index=0,
            src_token_index=0,
            src_balance_proof=_null_proof(log4_token_tree_size),
            src_fee_token_index=0,
            src_fee_balance_proof=_null_proof(log4_token_tree_size),
            dst_before=MpnAccount(), dst_before_balances_hash=0,
            dst_before_balance=Money(ContractId.NULL, 0),
            dst_proof=_null_proof(log4_tree_size), dst_index=0,
            dst_token_index=0,
            dst_balance_proof=_null_proof(log4_token_tree_size),
        )
