"""DB key schema (reference: src/db/keys.rs): the key builders of
`bazuka_tpu/db/keys.py` that `zk/state.py` and `mpn/` use.

Key layout matches the reference's string schema, including the
zero-padded numeric ordering and the `S-<cid>-...` contract-local
namespace used by the sparse Merkle state manager.
"""

from __future__ import annotations


def account_balance(address: str, token_id: str) -> str:
    return f"ACB-{address}-{token_id}"


def contract(contract_id: str) -> str:
    return f"CON-{contract_id}"


def mpn_account_index(mpn_address: str, index: int) -> str:
    return f"MPN-{mpn_address}-{index:x}"


def mpn_account_index_prefix(mpn_address: str) -> str:
    return f"MPN-{mpn_address}"


def mpn_account_count() -> str:
    return "MPN-CNT"


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
