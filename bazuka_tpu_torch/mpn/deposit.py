"""Deposit-batch witness generator (reference: src/mpn/deposit.rs).

aux_data commits to the accepted tx list: the root of a
List4^batch[Struct[enabled, token_id, amount, calldata]] state where
calldata = Poseidon2(pub.x, pub.y).

A copy of `bazuka_tpu/mpn/deposit.py`."""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..core.address import MpnAddress
from ..core.transaction import ContractId, Money, MpnDeposit
from ..db import Put, keys
from ..utils import ser
from ..zk.poseidon_host import PoseidonHasher
from ..zk.state import (
    SCALAR,
    ListModel,
    StateManager,
    Struct,
    ZkCompressedState,
    ZkStateBuilder,
    u64_to_blob,
)
from .account import ZERO_POINT, get_mpn_account, set_mpn_account
from .chain_view import MpnChainView
from .config import ZkPublicInputs
from .transitions import DepositTransition


def deposit_aux_model(log4_batch_size: int):
    return ListModel(
        log4_batch_size, Struct([SCALAR, SCALAR, SCALAR, SCALAR])
    )


def deposit(
    mpn_contract_id: ContractId,
    log4_tree_size: int,
    log4_token_tree_size: int,
    log4_batch_size: int,
    chain: MpnChainView,
    txs: List[MpnDeposit],
    new_account_indices: Dict[MpnAddress, int],
    check_balance: bool = True,
) -> Tuple[ZkCompressedState, ZkPublicInputs, List[DepositTransition]]:
    cid = str(mpn_contract_id)
    mgr = StateManager()
    mirror = chain.db.mirror()

    height = mgr.height_of(mirror, cid)
    root = mgr.root(mirror, cid)
    mpn_account_count = chain.get_mpn_account_count()
    state = root.state_hash
    state_size = root.state_size

    transitions: List[DepositTransition] = []
    rejected_pub_keys = set()

    for tx in txs:
        if len(transitions) == 1 << (2 * log4_batch_size):
            break
        mpn_addr = MpnAddress(tx.mpn_address)
        new_index = None
        inds = chain.get_mpn_account_indices(mpn_addr)
        if inds:
            account_index = inds[0]
        elif mpn_addr in new_account_indices:
            account_index = new_account_indices[mpn_addr]
        else:
            account_index = mpn_account_count + len(new_account_indices)
            new_index = account_index

        acc = get_mpn_account(mgr, mirror, cid, account_index)
        src_pub = tx.payment.src
        token_index = acc.find_token_index(
            log4_token_tree_size, tx.payment.amount.token_id, True
        )
        if token_index is None:
            rejected_pub_keys.add(src_pub)
            continue
        acc_token = acc.tokens.get(token_index)

        if (
            src_pub in rejected_pub_keys
            or (acc.address != ZERO_POINT and tx.mpn_address.decompress() != acc.address)
            or (acc_token is not None and acc_token.token_id != tx.payment.amount.token_id)
        ):
            rejected_pub_keys.add(src_pub)
            continue

        isolated = mirror.mirror()
        if check_balance:
            bal = chain.get_balance(src_pub, tx.payment.amount.token_id)
            if bal < tx.payment.amount.amount:
                rejected_pub_keys.add(src_pub)
                continue
            isolated.update(
                [
                    Put(
                        keys.account_balance(str(src_pub), str(tx.payment.amount.token_id)),
                        u64_to_blob(bal - tx.payment.amount.amount),
                    )
                ]
            )
            fee_bal = chain.get_balance(src_pub, tx.payment.fee.token_id)
            if fee_bal < tx.payment.fee.amount:
                rejected_pub_keys.add(src_pub)
                continue
            isolated.update(
                [
                    Put(
                        keys.account_balance(str(src_pub), str(tx.payment.fee.token_id)),
                        u64_to_blob(fee_bal - tx.payment.fee.amount),
                    )
                ]
            )

        updated = acc.copy()
        updated.address = tx.mpn_address.decompress()
        cur = updated.tokens.get(token_index, Money(tx.payment.amount.token_id, 0))
        updated.tokens[token_index] = Money(
            cur.token_id, cur.amount + tx.payment.amount.amount
        )

        balance_proof = mgr.prove(isolated, cid, (account_index, 4), token_index)
        proof = mgr.prove(isolated, cid, (), account_index)

        iso_size = set_mpn_account(mgr, isolated, cid, account_index, updated)

        if new_index is not None:
            new_account_indices[mpn_addr] = new_index
        transitions.append(
            DepositTransition(
                enabled=True,
                tx=tx,
                account_index=account_index,
                token_index=token_index,
                before=acc,
                before_balances_hash=acc.tokens_hash(log4_token_tree_size),
                before_balance=acc_token or Money(ContractId.NULL, 0),
                proof=proof,
                balance_proof=balance_proof,
            )
        )
        mirror.update(isolated.to_ops())
        state_size += iso_size

    next_state = mgr.get_data(mirror, cid, ())
    new_root = ZkCompressedState(next_state, state_size)
    mirror.update([Put(keys.local_root(cid), ser.dumps(new_root))])

    aux_data = compute_deposit_aux(transitions, log4_batch_size)

    chain.db.update(mirror.to_ops())
    return (
        new_root,
        ZkPublicInputs(height=height, state=state, aux_data=aux_data, next_state=next_state),
        transitions,
    )


def compute_deposit_aux(transitions, log4_batch_size: int) -> int:
    b = ZkStateBuilder(deposit_aux_model(log4_batch_size))
    for i, trans in enumerate(transitions):
        if not trans.enabled:
            continue
        pub = trans.tx.mpn_address.decompress()
        calldata = PoseidonHasher.hash([pub[0], pub[1]])
        b.batch_set(
            {
                (i, 0): 1,
                (i, 1): trans.tx.payment.amount.token_id.scalar,
                (i, 2): trans.tx.payment.amount.amount,
                (i, 3): calldata,
            }
        )
    return b.compress().state_hash
