"""Client / RPC layer (reference: src/client/).

The transport is an abstract async sender over `NodeRequest`s, so the
same node code runs against real sockets or the in-memory simulator
(reference: src/client/mod.rs:90-190 — `NodeRequest` over channels).
Wire format: JSON envelopes; chain objects travel as hex blobs of the
deterministic `ser` encoding (standing in for the reference's bincode
bodies on /bincode/* endpoints).  Requests may carry an ed25519
signature header `X-ZIESHA-SIGNATURE` (reference: src/client/mod.rs:142-157).
A copy of `bazuka_tpu/client/__init__.py`.
"""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from ..crypto.ed25519 import Ed25519
from ..utils import ser

SECOND = 1.0
KB = 1024
MB = 1024 * 1024


@dataclass(frozen=True)
class PeerAddress:
    """ip:port of a peer (reference: src/client/mod.rs PeerAddress)."""

    ip: str
    port: int

    def __str__(self):
        return f"{self.ip}:{self.port}"

    @staticmethod
    def parse(s: str) -> "PeerAddress":
        ip, port = s.rsplit(":", 1)
        return PeerAddress(ip, int(port))


@dataclass
class Limit:
    """Response size/time limits (reference: src/client/mod.rs:73-88)."""

    size: Optional[int] = None
    time: Optional[float] = None

    def with_size(self, size: int) -> "Limit":
        return Limit(size, self.time)

    def with_time(self, time: float) -> "Limit":
        return Limit(self.size, time)


@dataclass
class NodeRequest:
    method: str  # GET | POST
    path: str  # e.g. "/bincode/headers"
    query: Dict[str, str] = field(default_factory=dict)
    body: bytes = b""
    client_ip: Optional[str] = None  # None = local/loopback
    signature: Optional[tuple] = None  # (PublicKey, sig bytes)

    def json(self):
        return json.loads(self.body or b"{}")


@dataclass
class NodeResponse:
    status: int
    body: bytes

    def json(self):
        return json.loads(self.body or b"{}")


class OutgoingSender:
    """Sends NodeRequests somewhere — real HTTP or a simulator route
    (reference: src/client/mod.rs OutgoingSender)."""

    def __init__(self, send: Callable, signer=None):
        self._send = send  # async (PeerAddress, NodeRequest) -> NodeResponse
        self._signer = signer  # TxBuilder for signed requests

    async def request(
        self, peer: PeerAddress, req: NodeRequest, limit: Limit = Limit()
    ) -> NodeResponse:
        if self._signer is not None:
            sig = self._signer.sign(req.body)
            req.signature = (self._signer.get_address(), sig)
        coro = self._send(peer, req)
        if limit.time is not None:
            resp = await asyncio.wait_for(coro, timeout=limit.time)
        else:
            resp = await coro
        if limit.size is not None and len(resp.body) > limit.size:
            raise ValueError("response too large")
        return resp

    async def json_get(self, peer, path, params=None, limit=Limit()):
        resp = await self.request(
            peer,
            NodeRequest("GET", path, query={k: str(v) for k, v in (params or {}).items()}),
            limit,
        )
        if resp.status != 200:
            raise ValueError(f"http {resp.status} on {path}")
        return resp.json()

    async def json_post(self, peer, path, payload, limit=Limit()):
        resp = await self.request(
            peer,
            NodeRequest("POST", path, body=json.dumps(payload).encode()),
            limit,
        )
        if resp.status != 200:
            raise ValueError(f"http {resp.status} on {path}")
        return resp.json()

    # names kept for parity with the reference (bincode == our ser-hex JSON)
    bincode_get = json_get
    bincode_post = json_post


def verify_request_signature(req: NodeRequest) -> bool:
    if req.signature is None:
        return False
    pub, sig = req.signature
    return Ed25519.verify(pub, req.body, sig)


# ---------------------------------------------------------------- blob codecs


def to_hex(obj) -> str:
    return ser.dumps(obj).hex()


def from_hex(cls, h: str):
    return ser.loads(cls, bytes.fromhex(h))


class BazukaClient:
    """Typed convenience client (reference: src/client BazukaClient)."""

    def __init__(self, sender: OutgoingSender, peer: PeerAddress):
        self.sender = sender
        self.peer = peer

    async def stats(self):
        return await self.sender.json_get(self.peer, "/stats")

    async def get_headers(self, since: int, count: int):
        from ..core.header import Header

        resp = await self.sender.json_get(
            self.peer, "/bincode/headers", {"since": since, "count": count}
        )
        return [from_hex(Header, h) for h in resp["headers"]]

    async def get_blocks(self, since: int, count: int):
        from ..core.blocks import Block

        resp = await self.sender.json_get(
            self.peer, "/bincode/blocks", {"since": since, "count": count}
        )
        return [from_hex(Block, b) for b in resp["blocks"]]

    async def transact(self, tx):
        from ..core import GeneralTransaction

        if not isinstance(tx, GeneralTransaction):
            tx = GeneralTransaction(tx)
        return await self.sender.json_post(
            self.peer, "/bincode/transact", {"tx": to_hex(tx)}
        )

    async def get_account(self, address: str):
        return await self.sender.json_get(self.peer, "/account", {"address": address})

    async def get_balance(self, address: str, token_id: str):
        return await self.sender.json_get(
            self.peer, "/balance", {"address": address, "token_id": token_id}
        )

    async def get_mpn_account(self, address: str):
        return await self.sender.json_get(self.peer, "/mpn/account", {"address": address})

    async def get_mempool(self):
        return await self.sender.json_get(self.peer, "/mempool")

    async def get_peers(self):
        return await self.sender.json_get(self.peer, "/peers")

    async def shutdown(self):
        return await self.sender.json_post(self.peer, "/shutdown", {})
