"""Mempool: per-(kind, sender) FIFO queues with strict nonce chaining
(reference: src/blockchain/mempool.rs).
A copy of `bazuka_tpu/blockchain/mempool.py`.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ..core import GeneralTransaction, NonceGroup
from ..core.transaction import ContractId

BAN_THRESHOLD = 600  # 10 minutes of inactivity
BAN_TIME = 1200  # 20 minutes


@dataclass
class TransactionStats:
    first_seen: int
    is_local: bool
    claimed_timestamp: int = 0
    validity: str = "unknown"  # unknown | invalid | valid


class SingleMempool:
    """One sender's nonce-chained queue (reference: mempool.rs:38-116)."""

    def __init__(self, nonce: int):
        self.nonce = nonce
        self.txs: deque = deque()  # (GeneralTransaction, TransactionStats)
        self.last_exec = 0

    def __len__(self):
        return len(self.txs)

    def should_be_banned(self, now: int) -> bool:
        return bool(self.txs) and now - self.last_exec > BAN_THRESHOLD

    def first_nonce(self) -> Optional[int]:
        return self.txs[0][0].nonce() if self.txs else None

    def last_nonce(self) -> Optional[int]:
        return self.txs[-1][0].nonce() if self.txs else None

    def applicable(self, tx: GeneralTransaction) -> bool:
        last = self.last_nonce()
        if last is not None:
            return tx.nonce() == last + 1
        return tx.nonce() == self.nonce + 1

    def insert(self, tx: GeneralTransaction, stats: TransactionStats, now: int):
        if self.applicable(tx):
            self.txs.append((tx, stats))
            if self.last_exec == 0:
                self.last_exec = now

    def update_nonce(self, nonce: int, now: int):
        while self.txs and self.first_nonce() <= nonce:
            self.txs.popleft()
            self.last_exec = now
        if self.first_nonce() != nonce + 1 and self.txs:
            self.txs.clear()
            self.last_exec = now
        self.nonce = nonce

    def reset(self, nonce: int):
        if nonce == 0:
            self.txs.clear()
            return
        while self.txs and self.last_nonce() > nonce - 1:
            self.txs.pop()
        if self.last_nonce() != nonce - 1:
            self.txs.clear()


class Mempool:
    def __init__(self, min_balance_per_tx: int = 1_000_000_000):
        self.min_balance_per_tx = min_balance_per_tx
        self.txs: Dict[NonceGroup, SingleMempool] = {}
        self.min_fees: Dict[str, int] = {k: 0 for k in
                                         ("tx_delta", "mpn_deposit",
                                          "mpn_transaction", "mpn_withdraw")}
        self.rejected: Dict[GeneralTransaction, TransactionStats] = {}
        self.banned: Dict[str, int] = {}
        self.local_addrs: Set[str] = set()

    def __len__(self):
        return sum(len(m) for m in self.txs.values())

    def is_banned(self, addr: str, now: int) -> bool:
        until = self.banned.get(addr)
        if until is not None and now < until:
            return True
        self.banned.pop(addr, None)
        return False

    def _chain_nonce(self, chain, group: NonceGroup) -> int:
        from ..core.address import MpnAddress
        from ..crypto.ed25519 import PublicKey

        mpn_cid = chain.config.mpn_config.mpn_contract_id
        if group.kind == "tx_delta":
            return chain.get_nonce(PublicKey.parse(group.address))
        if group.kind == "mpn_deposit":
            return chain.get_deposit_nonce(PublicKey.parse(group.address), mpn_cid)
        acc = chain.get_mpn_account(MpnAddress.parse(group.address))
        if group.kind == "mpn_transaction":
            return acc.tx_nonce
        return acc.withdraw_nonce

    def refresh(self, chain, now: int):
        """Evict executed txs and ban inactive senders
        (reference: mempool.rs:180-209)."""
        banned_groups = []
        for group, pool in self.txs.items():
            pool.update_nonce(self._chain_nonce(chain, group), now)
            if group.address not in self.local_addrs and pool.should_be_banned(now):
                self.banned[group.address] = now + BAN_TIME
                banned_groups.append(group)
        for g in banned_groups:
            del self.txs[g]

    def add_tx(self, chain, tx: GeneralTransaction, is_local: bool, now: int,
               claimed_timestamp: int = 0):
        """(reference: mempool.rs:213-337)."""
        group = tx.nonce_group()
        if is_local:
            self.local_addrs.add(group.address)
        if not is_local and self.is_banned(tx.sender_str(), now):
            return
        if tx.fee().token_id != ContractId.ZIESHA:
            return
        if tx.fee().amount < self.min_fees.get(tx.kind, 0):
            return
        mpn_cid = chain.config.mpn_config.mpn_contract_id
        if tx.kind == "mpn_deposit":
            p = tx.inner.payment
            if p.contract_id != mpn_cid or p.deposit_circuit_id != 0:
                return
        if tx.kind == "mpn_withdraw":
            p = tx.inner.payment
            if p.contract_id != mpn_cid or p.withdraw_circuit_id != 0:
                return
        if is_local:
            self.rejected.pop(tx, None)
        if tx in self.rejected or not tx.verify_signature():
            return
        nonce = self._chain_nonce(chain, group)
        pool = self.txs.get(group)
        if pool is not None:
            pool.update_nonce(nonce, now)
            if is_local and not pool.applicable(tx):
                pool.reset(tx.nonce())
            if pool.txs:
                first_tx, stats = pool.txs[0]
                if claimed_timestamp > stats.claimed_timestamp and first_tx != tx:
                    pool.reset(tx.nonce())
            if not pool.applicable(tx):
                return
        if tx.nonce() <= nonce:
            return
        # balance-based per-sender limit: 1 tx per Ziesha of balance
        from ..core.address import MpnAddress
        from ..crypto.ed25519 import PublicKey

        if tx.kind in ("tx_delta", "mpn_deposit"):
            bal = chain.get_balance(PublicKey.parse(tx.sender_str()), ContractId.ZIESHA)
        else:
            acc = chain.get_mpn_account(MpnAddress.parse(tx.sender_str()))
            money = acc.tokens.get(0)
            bal = money.amount if money and money.token_id == ContractId.ZIESHA else 0
        limit = max(min(bal // self.min_balance_per_tx, 1000), 1)
        pool = self.txs.setdefault(group, SingleMempool(nonce))
        if is_local or len(pool) < limit:
            pool.insert(tx, TransactionStats(now, is_local, claimed_timestamp), now)

    def median_fees(self) -> Dict[str, int]:
        firsts: Dict[str, List[int]] = {}
        for group, pool in self.txs.items():
            if pool.txs:
                fee = pool.txs[0][0].fee()
                if fee.token_id == ContractId.ZIESHA:
                    firsts.setdefault(group.kind, []).append(fee.amount)
        return {
            k: sorted(v)[len(v) // 2] if v else 0 for k, v in firsts.items()
        }

    # -- iteration by kind

    def all(self) -> Iterator[Tuple[GeneralTransaction, TransactionStats]]:
        for pool in self.txs.values():
            yield from pool.txs

    def _by_kind(self, kind: str):
        for tx, stats in self.all():
            if tx.kind == kind:
                yield tx.inner, stats

    def tx_deltas(self):
        return self._by_kind("tx_delta")

    def mpn_deposits(self):
        return self._by_kind("mpn_deposit")

    def mpn_withdraws(self):
        return self._by_kind("mpn_withdraw")

    def mpn_txs(self):
        return self._by_kind("mpn_transaction")
