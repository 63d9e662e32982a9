"""In-process multi-node simulation with fault injection
(reference: src/node/test/simulation.rs).

N nodes are wired through a router task standing in for the network;
per-endpoint `Rule`s inject faults: Drop, Delay(seconds), Redirect(port).
This is how multi-node behavior is tested without a cluster — the
transport abstraction makes the simulator a drop-in for real HTTP.
A copy of `bazuka_tpu/node/simulation.py`.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..blockchain import KvStoreChain
from ..client import NodeRequest, NodeResponse, OutgoingSender, PeerAddress
from ..db import RamKvStore
from ..wallet.tx_builder import TxBuilder
from . import Node, get_simulator_options, node_create


@dataclass
class Rule:
    """Fault-injection rule matched by (target port, path substring)."""

    kind: str  # "drop" | "delay" | "redirect"
    port: Optional[int] = None  # None = any port
    path: Optional[str] = None  # None = any path
    delay: float = 0.0
    redirect_to: Optional[int] = None

    def matches(self, port: int, path: str) -> bool:
        if self.port is not None and self.port != port:
            return False
        if self.path is not None and self.path not in path:
            return False
        return True


class Simulation:
    """A wired set of in-process nodes."""

    def __init__(self):
        self.nodes: Dict[int, Node] = {}
        self.rules: List[Rule] = []
        self.tasks: List[asyncio.Task] = []

    def sender(self, from_ip: str) -> OutgoingSender:
        async def send(peer: PeerAddress, req: NodeRequest) -> NodeResponse:
            port = peer.port
            for rule in self.rules:
                if rule.matches(port, req.path):
                    if rule.kind == "drop":
                        raise ConnectionError("dropped by rule")
                    if rule.kind == "delay":
                        await asyncio.sleep(rule.delay)
                    if rule.kind == "redirect":
                        port = rule.redirect_to
            node = self.nodes.get(port)
            if node is None:
                raise ConnectionError(f"no node at port {port}")
            req.client_ip = from_ip
            return await node.submit(req)

        return OutgoingSender(send)

    def add_node(
        self,
        port: int,
        config,
        bootstrap: List[int] = (),
        seed: bytes = None,
        opts=None,
    ) -> Node:
        ip = f"10.0.0.{port % 250 + 1}"
        addr = PeerAddress(ip, port)
        seed = seed or f"node{port}".encode()
        node = node_create(
            opts or get_simulator_options(),
            network="sim",
            address=addr,
            bootstrap=[PeerAddress(f"10.0.0.{p % 250 + 1}", p) for p in bootstrap],
            blockchain=KvStoreChain(RamKvStore(), config),
            wallets=(TxBuilder(seed), TxBuilder(seed + b"-user")),
            outgoing=self.sender(ip),
        )
        self.nodes[port] = node
        return node

    async def start(self):
        for node in self.nodes.values():
            self.tasks.append(asyncio.create_task(node.run()))

    async def stop(self):
        for node in self.nodes.values():
            node.context.shutdown = True
        for t in self.tasks:
            t.cancel()
        await asyncio.gather(*self.tasks, return_exceptions=True)


async def catch_change(getter: Callable, timeout: float = 10.0, interval: float = 0.1):
    """Poll until `getter()` changes from its initial value; returns the new
    value (reference: src/node/test/mod.rs:19-33 catch_change)."""
    initial = getter()
    deadline = asyncio.get_event_loop().time() + timeout
    while asyncio.get_event_loop().time() < deadline:
        await asyncio.sleep(interval)
        cur = getter()
        if cur != initial:
            return cur
    raise TimeoutError("no change observed")
