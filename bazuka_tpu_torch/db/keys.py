"""DB key schema (reference: src/db/keys.rs).

Key layout matches the reference's string schema so the storage model is
directly comparable, including the zero-padded numeric ordering and the
`S-<cid>-...` contract-local namespace used by the sparse Merkle state
manager.
A copy of `bazuka_tpu/db/keys.py`.
"""

from __future__ import annotations

# ---------------- chain-global ----------------


def height() -> str:
    return "HGT"


def randomness() -> str:
    return "RND"


def power_at(index: int) -> str:
    return f"PWR-{index:010d}"


def block(index: int) -> str:
    return f"BLK-{index:010d}"


def header(index: int) -> str:
    return f"HDR-{index:010d}"


def rollback(index: int) -> str:
    return f"RLK-{index:010d}"


def merkle(index: int) -> str:
    return f"MRK-{index:010d}"


# ---------------- accounts / staking ----------------


def nonce(address: str) -> str:
    return f"NNC-{address}"


def deposit_nonce(address: str, contract_id: str) -> str:
    return f"DNC-{address}-{contract_id}"


def staker(address: str) -> str:
    return f"SKR-{address}"


def stake(address: str) -> str:
    return f"STK-{address}"


def auto_delegate(delegator: str, delegatee: str) -> str:
    return f"ADL-{delegator}-{delegatee}"


def delegate(delegator: str, delegatee: str) -> str:
    return f"DEL-{delegator}-{delegatee}"


def delegatee_prefix(delegator: str) -> str:
    return f"DEL-{delegator}-"


def delegator_rank(delegatee: str, amount: int, delegator: str) -> str:
    # descending-amount iteration via bitwise-complement hex amount
    return f"DRK-{delegatee}-{(2**64 - 1 - amount):016x}-{delegator}"


def delegator_rank_prefix(delegatee: str) -> str:
    return f"DRK-{delegatee}-"


def delegatee_rank(delegator: str, amount: int, delegatee: str) -> str:
    return f"DEK-{delegator}-{(2**64 - 1 - amount):016x}-{delegatee}"


def delegatee_rank_prefix(delegator: str) -> str:
    return f"DEK-{delegator}-"


def staker_rank(amount: int, address: str) -> str:
    return f"SRK-{(2**64 - 1 - amount):016x}-{address}"


def staker_rank_prefix() -> str:
    return "SRK-"


def rank_amount(key_part: str) -> int:
    """Recover the amount from an inverted-hex rank-key component."""
    return (2**64 - 1) - int(key_part, 16)


def undelegation(undelegator: str, undelegation_id: str) -> str:
    return f"UDL-{undelegator}-{undelegation_id}"


def undelegation_prefix(undelegator: str) -> str:
    return f"UDL-{undelegator}-"


def undelegation_callback(block: int, undelegation_id: str) -> str:
    return f"UCB-{block:010d}-{undelegation_id}"


def undelegation_callback_prefix(block: int) -> str:
    return f"UCB-{block:010d}-"


def account_balance(address: str, token_id: str) -> str:
    return f"ACB-{address}-{token_id}"


# ---------------- contracts / tokens ----------------


def contract_account(contract_id: str) -> str:
    return f"CAC-{contract_id}"


def contract_balance(contract_id: str, token_id: str) -> str:
    return f"CAB-{contract_id}-{token_id}"


def contract(contract_id: str) -> str:
    return f"CON-{contract_id}"


def token(token_id: str) -> str:
    return f"TKN-{token_id}"


# ---------------- MPN index ----------------


def mpn_account_index(mpn_address: str, index: int) -> str:
    return f"MPN-{mpn_address}-{index:x}"


def mpn_account_index_prefix(mpn_address: str) -> str:
    return f"MPN-{mpn_address}"


def mpn_account_count() -> str:
    return "MPN-CNT"


# ---------------- contract-local state (sparse Merkle forest) ----------------


def local_prefix(contract_id: str) -> str:
    return f"S-{contract_id}"


def local_height(contract_id: str) -> str:
    return f"{local_prefix(contract_id)}-HGT"


def local_root(contract_id: str) -> str:
    return f"{local_prefix(contract_id)}-RT"


def local_tree_aux(contract_id: str, tree_loc: str, aux_id: int) -> str:
    return f"{local_prefix(contract_id)}-{tree_loc}-T-{aux_id}"


def local_scalar_value_prefix(contract_id: str) -> str:
    return f"{local_prefix(contract_id)}-S"


def local_value(contract_id: str, locator: str, is_scalar: bool) -> str:
    pre = (
        local_scalar_value_prefix(contract_id)
        if is_scalar
        else local_prefix(contract_id)
    )
    return f"{pre}-{locator}"
