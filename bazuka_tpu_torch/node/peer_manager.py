"""Peer bookkeeping: candidates, verified nodes, punishments
(reference: src/node/peer_manager.rs).
A copy of `bazuka_tpu/node/peer_manager.py`.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..client import PeerAddress


@dataclass
class Peer:
    address: PeerAddress
    height: int
    power: float
    pub_key: str  # validator address string

    def to_json(self):
        return {
            "address": str(self.address),
            "height": self.height,
            "power": self.power,
            "pub_key": self.pub_key,
        }

    @staticmethod
    def from_json(d):
        return Peer(PeerAddress.parse(d["address"]), d["height"], d["power"], d["pub_key"])


class PeerManager:
    def __init__(self, self_addr: Optional[PeerAddress], bootstrap: List[PeerAddress],
                 now: int, candidate_remove_threshold: int):
        self.self_addr = self_addr
        self.candidate_remove_threshold = candidate_remove_threshold
        self.candidates: Dict[str, tuple] = {
            b.ip: (b, now) for b in bootstrap
        }  # ip -> (address, since)
        self.nodes: Dict[str, tuple] = {}  # ip -> (Peer, ping_time)
        self.punishments: Dict[str, int] = {}  # ip -> punished_till
        self.peers: List[str] = []  # selected ips

    def refresh(self, now: int):
        self.punishments = {
            ip: till for ip, till in self.punishments.items() if now <= till
        }
        self.candidates = {
            ip: det for ip, det in self.candidates.items()
            if now - det[1] < self.candidate_remove_threshold
        }

    def is_ip_punished(self, now: int, ip: str) -> bool:
        till = self.punishments.get(ip)
        return till is not None and now < till

    def punish_ip_for(self, now: int, ip: str, secs: int):
        self.candidates.pop(ip, None)
        self.nodes.pop(ip, None)
        self.punishments[ip] = now + secs

    def mark_as_candidate(self, now: int, addr: PeerAddress):
        if addr.ip in self.nodes:
            del self.nodes[addr.ip]
            self.candidates[addr.ip] = (addr, now)

    def node_count(self) -> int:
        return len(self.nodes)

    def get_nodes(self):
        return [p for p, _ in self.nodes.values()]

    def random_candidates(self, count: int) -> List[PeerAddress]:
        vals = list(self.candidates.values())
        return [a for a, _ in random.sample(vals, min(count, len(vals)))]

    def select_peers(self, count: int):
        vals = sorted(self.nodes.values(), key=lambda d: d[1])
        self.peers = [d[0].address.ip for d in vals[:count]]

    def get_peers(self) -> List[Peer]:
        return [self.nodes[ip][0] for ip in self.peers if ip in self.nodes]

    def add_candidate(self, now: int, addr: PeerAddress):
        if self.self_addr == addr:
            return
        if addr.ip not in self.nodes:
            self.candidates[addr.ip] = (addr, now)

    def add_node(self, peer: Peer, ping_time: float):
        if self.self_addr == peer.address:
            return
        self.candidates.pop(peer.address.ip, None)
        self.nodes[peer.address.ip] = (peer, ping_time)
