"""Update-batch witness generator (reference: src/mpn/update.rs).

Replays candidate L2 transfers against an isolated fork per tx
(src balance → src fee → dst, in that exact order so the captured Merkle
proofs line up with the circuit's three tree-update passes), rejecting
invalid txs, and emits UpdateTransitions + ZkPublicInputs with
aux_data = Poseidon2(fee_token, Σ accepted fees).

A copy of `bazuka_tpu/mpn/update.py`."""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..core.address import MpnAddress
from ..core.transaction import ContractId, Money, MpnTransaction
from ..db import Put, keys
from ..utils import ser
from ..zk.poseidon_host import PoseidonHasher
from ..zk.state import StateManager, ZkCompressedState
from .account import ZERO_POINT, get_mpn_account, set_mpn_account
from .chain_view import MpnChainView
from .config import ZkPublicInputs
from .transitions import UpdateTransition


def update(
    mpn_contract_id: ContractId,
    log4_tree_size: int,
    log4_token_tree_size: int,
    log4_batch_size: int,
    fee_token: ContractId,
    chain: MpnChainView,
    txs: List[MpnTransaction],
    new_account_indices: Dict[MpnAddress, int],
) -> Tuple[ZkCompressedState, ZkPublicInputs, List[UpdateTransition]]:
    cid = str(mpn_contract_id)
    mgr = StateManager()
    mirror = chain.db.mirror()

    root = mgr.root(mirror, cid)
    height = mgr.height_of(mirror, cid)
    mpn_account_count = chain.get_mpn_account_count()
    state = root.state_hash
    state_size = root.state_size

    accepted: List[MpnTransaction] = []
    transitions: List[UpdateTransition] = []

    # pre-filter (reference: update.rs:31-38 — rayon par_iter; batched
    # signature checks happen at the mempool boundary instead)
    candidates = [
        tx
        for tx in txs
        if tx.fee.token_id == fee_token
        and tx.src_pub_key.is_on_curve()
        and tx.dst_pub_key.is_on_curve()
    ]

    for tx in candidates:
        if len(transitions) == 1 << (2 * log4_batch_size):
            break
        new_dst_index = None
        src_addr = MpnAddress(tx.src_pub_key)
        dst_addr = MpnAddress(tx.dst_pub_key)

        inds = chain.get_mpn_account_indices(src_addr)
        if inds:
            src_index = inds[0]
        elif src_addr in new_account_indices:
            src_index = new_account_indices[src_addr]
        else:
            continue  # rejected

        inds = chain.get_mpn_account_indices(dst_addr)
        if inds:
            dst_index = inds[0]
        elif dst_addr in new_account_indices:
            dst_index = new_account_indices[dst_addr]
        else:
            dst_index = mpn_account_count + len(new_account_indices)
            new_dst_index = dst_index

        src_before = get_mpn_account(mgr, mirror, cid, src_index)
        dst_before = get_mpn_account(mgr, mirror, cid, dst_index)

        src_token_index = src_before.find_token_index(
            log4_token_tree_size, tx.amount.token_id, False
        )
        dst_token_index = dst_before.find_token_index(
            log4_token_tree_size, tx.amount.token_id, True
        )
        src_fee_token_index = src_before.find_token_index(
            log4_token_tree_size, tx.fee.token_id, False
        )
        if src_token_index is None or dst_token_index is None or src_fee_token_index is None:
            continue
        src_token = src_before.tokens.get(src_token_index)
        if src_token is None:
            continue
        dst_token = dst_before.tokens.get(dst_token_index)

        if (
            tx.nonce != src_before.tx_nonce + 1
            or src_before.address != tx.src_pub_key.decompress()
            or (
                dst_before.address != ZERO_POINT
                and dst_before.address != tx.dst_pub_key.decompress()
            )
            or (dst_token is not None and src_token.token_id != dst_token.token_id)
            or src_token.token_id != tx.amount.token_id
            or src_token.amount < tx.amount.amount
        ):
            continue

        isolated = mirror.mirror()
        iso_size = 0

        src_proof = mgr.prove(isolated, cid, (), src_index)
        src_after = src_before.copy()
        src_after.tx_nonce += 1
        src_balance_proof = mgr.prove(isolated, cid, (src_index, 4), src_token_index)
        src_after.tokens[src_token_index] = Money(
            src_token.token_id, src_token.amount - tx.amount.amount
        )
        iso_size += set_mpn_account(mgr, isolated, cid, src_index, src_after)

        src_fee_token = src_after.tokens.get(src_fee_token_index)
        if src_fee_token is None:
            continue
        if (
            src_fee_token.token_id != tx.fee.token_id
            or src_fee_token.amount < tx.fee.amount
        ):
            continue
        src_fee_balance_proof = mgr.prove(
            isolated, cid, (src_index, 4), src_fee_token_index
        )
        src_after.tokens[src_fee_token_index] = Money(
            src_fee_token.token_id, src_fee_token.amount - tx.fee.amount
        )
        iso_size += set_mpn_account(mgr, isolated, cid, src_index, src_after)

        dst_proof = mgr.prove(isolated, cid, (), dst_index)
        dst_balance_proof = mgr.prove(isolated, cid, (dst_index, 4), dst_token_index)

        # re-read (src == dst self-transfers must see the updated state)
        dst_before2 = get_mpn_account(mgr, isolated, cid, dst_index)
        dst_token2 = dst_before2.tokens.get(dst_token_index)
        dst_after = dst_before2.copy()
        dst_after.address = tx.dst_pub_key.decompress()
        cur = dst_after.tokens.get(
            dst_token_index, Money(tx.amount.token_id, 0)
        )
        dst_after.tokens[dst_token_index] = Money(
            cur.token_id, cur.amount + tx.amount.amount
        )
        iso_size += set_mpn_account(mgr, isolated, cid, dst_index, dst_after)

        if new_dst_index is not None:
            new_account_indices[dst_addr] = new_dst_index
        transitions.append(
            UpdateTransition(
                enabled=True,
                tx=tx,
                src_before=src_before,
                src_before_balances_hash=src_before.tokens_hash(log4_token_tree_size),
                src_before_balance=src_token,
                src_before_fee_balance=src_fee_token,
                src_proof=src_proof,
                src_index=src_index,
                src_token_index=src_token_index,
                src_balance_proof=src_balance_proof,
                src_fee_token_index=src_fee_token_index,
                src_fee_balance_proof=src_fee_balance_proof,
                dst_before=dst_before2,
                dst_before_balances_hash=dst_before2.tokens_hash(log4_token_tree_size),
                dst_before_balance=dst_token2 or Money(ContractId.NULL, 0),
                dst_proof=dst_proof,
                dst_index=dst_index,
                dst_token_index=dst_token_index,
                dst_balance_proof=dst_balance_proof,
            )
        )
        accepted.append(tx)
        mirror.update(isolated.to_ops())
        state_size += iso_size

    next_state = mgr.get_data(mirror, cid, ())
    new_root = ZkCompressedState(next_state, state_size)
    mirror.update([Put(keys.local_root(cid), ser.dumps(new_root))])

    aux_data = PoseidonHasher.hash(
        [fee_token.scalar, sum(tx.fee.amount for tx in accepted)]
    )

    chain.db.update(mirror.to_ops())
    return (
        new_root,
        ZkPublicInputs(height=height, state=state, aux_data=aux_data, next_state=next_state),
        transitions,
    )
