"""Shared node state (reference: src/node/context.rs).
A copy of `bazuka_tpu/node/context.py`."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from ..blockchain import Mempool
from ..client import OutgoingSender, PeerAddress
from ..core import GeneralTransaction
from ..mpn.workpool import MpnWorkPool, MpnWorker
from .firewall import Firewall
from .peer_manager import Peer, PeerManager


@dataclass
class ValidatorClaim:
    """A validator's signed claim to the current slot
    (reference: src/client/messages.rs ValidatorClaim)."""

    timestamp: int
    address: object  # ed25519 PublicKey
    proof: object  # ValidatorProof
    node: PeerAddress
    sig: Optional[bytes] = None

    def signing_bytes(self) -> bytes:
        from ..utils import ser

        w = ser.Writer()
        w.u32(self.timestamp)
        w.raw(self.address.raw)
        self.proof.write_to(w)
        w.string(str(self.node))
        return w.getvalue()

    def verify_signature(self) -> bool:
        from ..crypto.ed25519 import Ed25519

        if self.sig is None:
            return False
        return Ed25519.verify(self.address, self.signing_bytes(), self.sig)


@dataclass
class NodeContext:
    opts: object
    network: str
    address: Optional[PeerAddress]
    outgoing: OutgoingSender
    blockchain: object
    validator_wallet: object
    user_wallet: object
    peer_manager: PeerManager
    firewall: Optional[Firewall] = None
    shutdown: bool = False
    timestamp_offset: int = 0  # learned correction (sync_clock heartbeat)
    clock_skew: int = 0  # simulated wall-clock error (tests; reference
    #                      NodeOpts.timestamp_offset, test/mod.rs:180)
    validator_claim: Optional[ValidatorClaim] = None
    mpn_workers: Dict[str, MpnWorker] = field(default_factory=dict)
    mpn_work_pool: Optional[MpnWorkPool] = None
    mempool: Mempool = field(default_factory=Mempool)

    def local_timestamp(self) -> int:
        return int(time.time()) + self.clock_skew

    def network_timestamp(self) -> int:
        return self.local_timestamp() + self.timestamp_offset

    def punish_bad_behavior(self, bad_peer: PeerAddress, secs: int, reason: str):
        self.peer_manager.punish_ip_for(self.local_timestamp(), bad_peer.ip, secs)

    def punish_unresponsive(self, bad_peer: PeerAddress):
        self.peer_manager.mark_as_candidate(self.local_timestamp(), bad_peer)

    def get_info(self) -> Optional[Peer]:
        if self.address is None:
            return None
        return Peer(
            address=self.address,
            height=self.blockchain.get_height(),
            power=self.blockchain.get_power(),
            pub_key=str(self.validator_wallet.get_address()),
        )

    def refresh(self):
        now = self.local_timestamp()
        self.peer_manager.refresh(now)
        if self.firewall:
            self.firewall.refresh(now)

    def mempool_add_tx(self, is_local: bool, tx: GeneralTransaction,
                       claimed_timestamp: int = 0):
        self.mempool.add_tx(
            self.blockchain, tx, is_local, self.local_timestamp(), claimed_timestamp
        )

    def on_update(self):
        """Called whenever the chain extends or rolls back."""
        self.mempool.refresh(self.blockchain, self.local_timestamp())

    def update_validator_claim(self, claim: ValidatorClaim) -> bool:
        """Track the slot's winning claim (reference: context.rs:101-131)."""
        if self.validator_claim == claim:
            return False
        if self.validator_claim is not None:
            cur = self.validator_claim
            if (
                self.blockchain.epoch_slot(cur.timestamp)
                == self.blockchain.epoch_slot(claim.timestamp)
                and claim.proof.attempt >= cur.proof.attempt
            ):
                return False
        ts = self.network_timestamp()
        if self.blockchain.is_validator(ts, claim.address, claim.proof) and claim.verify_signature():
            self.validator_claim = claim
            return True
        return False

    def try_produce(self, wallet):
        """Draft + self-apply a block (reference: context.rs:133-155)."""
        ts = self.network_timestamp()
        raw_txs = [tx for tx, _ in self.mempool.tx_deltas()]
        draft = self.blockchain.draft_block(ts, raw_txs, wallet, check=True)
        if draft is not None:
            self.blockchain.extend(draft.header.number, [draft])
            self.on_update()
        return draft
