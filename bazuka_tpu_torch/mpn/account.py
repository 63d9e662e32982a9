"""MPN account: leaf = Struct[tx_nonce, withdraw_nonce, pub_x, pub_y,
List4^t[Struct[token_id, balance]]] (reference: src/zk/mod.rs:59-114,
src/zk/state/mod.rs:93-208).
A copy of `bazuka_tpu/mpn/account.py`."""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple

from ..core.transaction import ContractId, Money
from ..db import KvStore
from ..zk.poseidon_host import PoseidonHasher
from ..zk.state import (
    SCALAR,
    ListModel,
    StateManager,
    Struct,
    ZkStateBuilder,
)

ZERO_POINT = (0, 0)  # default (uninitialized) account address


@dataclass
class MpnAccount:
    tx_nonce: int = 0
    withdraw_nonce: int = 0
    address: Tuple[int, int] = ZERO_POINT  # affine jubjub point
    tokens: Dict[int, Money] = field(default_factory=dict)

    def copy(self) -> "MpnAccount":
        return MpnAccount(
            self.tx_nonce, self.withdraw_nonce, self.address, dict(self.tokens)
        )

    def tokens_hash(self, log4_token_capacity: int, hasher=PoseidonHasher) -> int:
        """Root of the token subtree alone (reference: src/zk/mod.rs:68-93)."""
        model = ListModel(log4_token_capacity, Struct([SCALAR, SCALAR]))
        b = ZkStateBuilder(model, hasher)
        for i, money in self.tokens.items():
            b.batch_set({(i, 0): money.token_id.scalar, (i, 1): money.amount})
        return b.compress().state_hash

    def find_token_index(
        self, log4_token_capacity: int, token_id: ContractId, empty_allowed: bool
    ) -> Optional[int]:
        """First slot holding token_id; if empty_allowed, first free slot
        (reference: src/zk/mod.rs:95-114)."""
        for ind, money in self.tokens.items():
            if money.token_id == token_id:
                return ind
        if empty_allowed:
            for ind in range(1 << (2 * log4_token_capacity)):
                if ind not in self.tokens:
                    return ind
        return None


def get_mpn_account(
    mgr: StateManager, db: KvStore, cid: str, index: int
) -> MpnAccount:
    """Read one account from the sparse tree (reference:
    src/zk/state/mod.rs:93-140)."""
    from ..db import keys
    from ..zk.state import loc_parse

    cells = [mgr.get_data(db, cid, (index, i)) for i in range(4)]
    token_indices = set()
    prefix = keys.local_value(cid, f"{index:x}_4", True)
    for k, _ in db.pairs(prefix):
        loc = loc_parse(k.split("-")[3])
        if len(loc) == 4:
            token_indices.add(loc[2])
    tokens = {}
    for i in sorted(token_indices):
        tok = mgr.get_data(db, cid, (index, 4, i, 0))
        bal = mgr.get_data(db, cid, (index, 4, i, 1))
        if tok != 0:
            tokens[i] = Money(ContractId(tok), bal)
    return MpnAccount(
        tx_nonce=cells[0], withdraw_nonce=cells[1],
        address=(cells[2], cells[3]), tokens=tokens,
    )


def set_mpn_account(
    mgr: StateManager, db: KvStore, cid: str, index: int, acc: MpnAccount
) -> int:
    """Write an account; returns the state-size delta (reference:
    src/zk/state/mod.rs:166-208)."""
    size_diff = 0
    vals = [acc.tx_nonce, acc.withdraw_nonce, acc.address[0], acc.address[1]]
    for i, val in enumerate(vals):
        _, d = mgr.set_data(db, cid, (index, i), val)
        size_diff += d
    for ind, money in acc.tokens.items():
        _, d = mgr.set_data(db, cid, (index, 4, ind, 0), money.token_id.scalar)
        size_diff += d
        _, d = mgr.set_data(db, cid, (index, 4, ind, 1), money.amount)
        size_diff += d
    return size_diff


def get_mpn_accounts(
    mgr: StateManager, db: KvStore, cid: str, page: int, page_size: int
):
    """Paged account listing (reference: src/zk/state/mod.rs:141-165)."""
    from ..db import keys
    from ..zk.state import loc_parse

    indices = set()
    for k, _ in db.pairs(keys.local_scalar_value_prefix(cid)):
        loc = loc_parse(k.split("-")[3])
        indices.add(loc[0])
    out = []
    for ind in sorted(indices)[page_size * page : page_size * (page + 1)]:
        out.append((ind, get_mpn_account(mgr, db, cid, ind)))
    return out
