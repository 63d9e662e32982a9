"""Minimal chain interface the MPN witness generators need.

The JAX package's full blockchain (`bazuka_tpu.blockchain`) satisfies
this protocol; the standalone `MpnChainView` runs the rollup engine
against a bare KV store (used by the tests and by `chip_smoke.py`).

A copy of `bazuka_tpu/mpn/chain_view.py`."""

from __future__ import annotations

from typing import List

from ..core.address import MpnAddress
from ..core.transaction import ContractId
from ..db import KvStore, Put, keys
from ..zk.state import blob_to_u64, u64_to_blob


class MpnChainView:
    """KvStore-backed implementation of the MPN bookkeeping interface
    (reference: the Blockchain trait methods get_mpn_account_indices /
    get_mpn_account_count / get_balance, src/blockchain/mod.rs)."""

    def __init__(self, db: KvStore):
        self.db = db

    # -- account index bookkeeping (keys MPN-<addr>-<idx>, MPN-CNT)

    def get_mpn_account_indices(self, addr: MpnAddress) -> List[int]:
        prefix = keys.mpn_account_index_prefix(str(addr))
        out = []
        for k, _ in self.db.pairs(prefix + "-"):
            out.append(int(k.rsplit("-", 1)[1], 16))
        return sorted(out)

    def get_mpn_account_count(self) -> int:
        blob = self.db.get(keys.mpn_account_count())
        return blob_to_u64(blob) if blob is not None else 0

    def add_mpn_account_index(self, addr: MpnAddress, index: int) -> None:
        count = self.get_mpn_account_count()
        self.db.update(
            [
                Put(keys.mpn_account_index(str(addr), index), b""),
                Put(keys.mpn_account_count(), u64_to_blob(max(count, index + 1))),
            ]
        )

    # -- L1 balances

    def get_balance(self, address, token_id: ContractId) -> int:
        blob = self.db.get(keys.account_balance(str(address), str(token_id)))
        return blob_to_u64(blob) if blob is not None else 0

    def set_balance(self, address, token_id: ContractId, amount: int) -> None:
        self.db.update(
            [Put(keys.account_balance(str(address), str(token_id)), u64_to_blob(amount))]
        )
