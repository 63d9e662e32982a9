"""Withdraw-batch witness generator (reference: src/mpn/withdraw.rs).

aux_data commits to the accepted tx list: the root of a
List4^batch[Struct[enabled, token_id, amount, fee_token, fee,
fingerprint, calldata]] where calldata = Poseidon6(pub.x, pub.y, nonce,
sig.r.x, sig.r.y, sig.s).

A copy of `bazuka_tpu/mpn/withdraw.py`."""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..core.address import MpnAddress
from ..core.transaction import ContractId, Money, MpnWithdraw
from ..db import Put, keys
from ..utils import ser
from ..zk.state import (
    SCALAR,
    ListModel,
    StateManager,
    Struct,
    ZkCompressedState,
    ZkStateBuilder,
)
from .account import ZERO_POINT, get_mpn_account, set_mpn_account
from .chain_view import MpnChainView
from .config import ZkPublicInputs
from .transitions import WithdrawTransition


def withdraw_aux_model(log4_batch_size: int):
    return ListModel(
        log4_batch_size,
        Struct([SCALAR] * 7),
    )


def withdraw(
    mpn_contract_id: ContractId,
    log4_tree_size: int,
    log4_token_tree_size: int,
    log4_batch_size: int,
    chain: MpnChainView,
    txs: List[MpnWithdraw],
    new_account_indices: Dict[MpnAddress, int],
) -> Tuple[ZkCompressedState, ZkPublicInputs, List[WithdrawTransition]]:
    cid = str(mpn_contract_id)
    mgr = StateManager()
    mirror = chain.db.mirror()

    height = mgr.height_of(mirror, cid)
    root = mgr.root(mirror, cid)
    state = root.state_hash
    state_size = root.state_size

    transitions: List[WithdrawTransition] = []

    for tx in txs:
        if len(transitions) == 1 << (2 * log4_batch_size):
            break
        mpn_addr = MpnAddress(tx.mpn_address)
        inds = chain.get_mpn_account_indices(mpn_addr)
        if inds:
            account_index = inds[0]
        elif mpn_addr in new_account_indices:
            account_index = new_account_indices[mpn_addr]
        else:
            continue

        acc = get_mpn_account(mgr, mirror, cid, account_index)
        token_index = acc.find_token_index(
            log4_token_tree_size, tx.payment.amount.token_id, False
        )
        fee_token_index = acc.find_token_index(
            log4_token_tree_size, tx.payment.fee.token_id, False
        )
        if token_index is None or fee_token_index is None:
            continue
        acc_token = acc.tokens.get(token_index)
        if acc_token is None:
            continue

        if (
            (acc.address != ZERO_POINT and tx.mpn_address.decompress() != acc.address)
            or not tx.verify_calldata()
            or not tx.verify_signature()
            or tx.mpn_withdraw_nonce != acc.withdraw_nonce + 1
            or tx.payment.amount.token_id != acc_token.token_id
            or tx.payment.amount.amount > acc_token.amount
        ):
            continue

        isolated = mirror.mirror()
        iso_size = 0

        updated = acc.copy()
        updated.address = tx.mpn_address.decompress()
        updated.withdraw_nonce += 1

        before_token_hash = updated.tokens_hash(log4_token_tree_size)
        token_balance_proof = mgr.prove(isolated, cid, (account_index, 4), token_index)
        updated.tokens[token_index] = Money(
            acc_token.token_id, acc_token.amount - tx.payment.amount.amount
        )
        iso_size += set_mpn_account(mgr, isolated, cid, account_index, updated)

        fee_balance_proof = mgr.prove(isolated, cid, (account_index, 4), fee_token_index)
        acc_fee_token = updated.tokens.get(fee_token_index)
        if acc_fee_token is None:
            continue
        if (
            tx.payment.fee.token_id != acc_fee_token.token_id
            or tx.payment.fee.amount > acc_fee_token.amount
        ):
            continue
        updated.tokens[fee_token_index] = Money(
            acc_fee_token.token_id, acc_fee_token.amount - tx.payment.fee.amount
        )

        proof = mgr.prove(isolated, cid, (), account_index)
        iso_size += set_mpn_account(mgr, isolated, cid, account_index, updated)

        transitions.append(
            WithdrawTransition(
                enabled=True,
                account_index=account_index,
                token_index=token_index,
                fee_token_index=fee_token_index,
                tx=tx,
                before=acc,
                before_token_balance=acc_token,
                before_fee_balance=acc_fee_token,
                proof=proof,
                token_balance_proof=token_balance_proof,
                fee_balance_proof=fee_balance_proof,
                before_token_hash=before_token_hash,
            )
        )
        mirror.update(isolated.to_ops())
        state_size += iso_size

    next_state = mgr.get_data(mirror, cid, ())
    new_root = ZkCompressedState(next_state, state_size)
    mirror.update([Put(keys.local_root(cid), ser.dumps(new_root))])

    aux_data = compute_withdraw_aux(transitions, log4_batch_size)

    chain.db.update(mirror.to_ops())
    return (
        new_root,
        ZkPublicInputs(height=height, state=state, aux_data=aux_data, next_state=next_state),
        transitions,
    )


def compute_withdraw_aux(transitions, log4_batch_size: int) -> int:
    b = ZkStateBuilder(withdraw_aux_model(log4_batch_size))
    for i, trans in enumerate(transitions):
        if not trans.enabled:
            continue
        b.batch_set(
            {
                (i, 0): 1,
                (i, 1): trans.tx.payment.amount.token_id.scalar,
                (i, 2): trans.tx.payment.amount.amount,
                (i, 3): trans.tx.payment.fee.token_id.scalar,
                (i, 4): trans.tx.payment.fee.amount,
                (i, 5): trans.tx.payment.fingerprint(),
                (i, 6): trans.tx.calldata(),
            }
        )
    return b.compress().state_hash
