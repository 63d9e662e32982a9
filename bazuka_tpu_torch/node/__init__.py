"""Node runtime (reference: src/node/).

`node_create` builds a `Node` whose async `run()` serves the request
queue and drives the 8 heartbeat loops.  The transport is abstract
(`OutgoingSender` + an incoming queue of NodeRequests) so the same node
runs against real sockets (`serve_http`) or the in-memory simulator
(`bazuka_tpu_torch.node.simulation`).
A copy of `bazuka_tpu/node/__init__.py`.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field

from ..client import NodeRequest, NodeResponse, OutgoingSender, PeerAddress
from .api import node_service
from .context import NodeContext
from .firewall import Firewall
from .heartbeat import heartbeater
from .peer_manager import Peer, PeerManager


@dataclass
class HeartbeatIntervals:
    log_info: float = 5.0
    refresh: float = 10.0
    sync_peers: float = 60.0
    discover_peers: float = 10.0
    sync_clock: float = 10.0
    sync_blocks: float = 10.0
    sync_mempool: float = 30.0
    generate_block: float = 3.0


@dataclass
class NodeOptions:
    """(reference: src/config/node.rs)."""

    tx_max_time_alive: int | None = 600
    heartbeat_intervals: HeartbeatIntervals = field(default_factory=HeartbeatIntervals)
    num_peers: int = 8
    max_blocks_fetch: int = 16
    default_punish: int = 60
    no_response_punish: int = 600
    invalid_data_punish: int = 3600
    max_punish: int = 7200
    incorrect_chain_punish: int = 3600
    candidate_remove_threshold: int = 3600
    mempool_max_fetch: int = 1000
    max_block_time_difference: int = 120
    automatic_block_generation: bool = True


def get_node_options() -> NodeOptions:
    return NodeOptions()


def get_simulator_options() -> NodeOptions:
    """Sub-second heartbeats for in-process simulation
    (reference: src/config/node.rs:31-60)."""
    return NodeOptions(
        tx_max_time_alive=None,
        heartbeat_intervals=HeartbeatIntervals(
            log_info=1.0, refresh=0.3, sync_peers=0.3, discover_peers=0.3,
            sync_clock=0.3, sync_blocks=0.3, sync_mempool=0.3,
            generate_block=0.3,
        ),
        default_punish=0, no_response_punish=0, invalid_data_punish=0,
        max_punish=0, incorrect_chain_punish=0,
        candidate_remove_threshold=600,
        automatic_block_generation=False,
    )


class Node:
    def __init__(self, context: NodeContext):
        self.context = context
        self.incoming: asyncio.Queue = asyncio.Queue()
        self._lock = asyncio.Lock()

    async def handle(self, req: NodeRequest) -> NodeResponse:
        """Service one request (firewall + punish middleware + router)."""
        ctx = self.context
        ip = req.client_ip
        is_local = ip in (None, "127.0.0.1", "::1")
        now = ctx.local_timestamp()
        if not is_local:
            if ctx.firewall and not ctx.firewall.incoming_permitted(ip):
                return NodeResponse(429, b"{}")
            if ctx.peer_manager.is_ip_punished(now, ip):
                return NodeResponse(403, b"{}")
        async with self._lock:
            try:
                return await node_service(ctx, req, is_local)
            except Exception as e:
                if not is_local and ip is not None:
                    ctx.peer_manager.punish_ip_for(now, ip, ctx.opts.default_punish)
                return NodeResponse(500, f'{{"error": "{type(e).__name__}"}}'.encode())

    async def run(self):
        """Serve the incoming queue + heartbeats until shutdown
        (reference: src/node/mod.rs:457-530 node_create/try_join)."""
        server = asyncio.create_task(self._serve())
        beats = asyncio.create_task(heartbeater(self))
        try:
            await asyncio.gather(server, beats)
        except asyncio.CancelledError:
            pass

    async def _serve(self):
        while not self.context.shutdown:
            try:
                req, fut = await asyncio.wait_for(self.incoming.get(), timeout=0.2)
            except asyncio.TimeoutError:
                continue
            resp = await self.handle(req)
            if not fut.done():
                fut.set_result(resp)

    async def submit(self, req: NodeRequest) -> NodeResponse:
        """Entry point used by transports (HTTP bridge or simulator)."""
        fut = asyncio.get_event_loop().create_future()
        await self.incoming.put((req, fut))
        return await fut


def node_create(
    opts: NodeOptions,
    network: str,
    address: PeerAddress | None,
    bootstrap: list,
    blockchain,
    wallets,  # (validator TxBuilder, user TxBuilder)
    outgoing: OutgoingSender,
    firewall: Firewall | None = None,
    mpn_workers: dict | None = None,
) -> Node:
    validator_wallet, user_wallet = wallets
    ctx = NodeContext(
        opts=opts,
        network=network,
        address=address,
        firewall=firewall,
        outgoing=outgoing,
        blockchain=blockchain,
        validator_wallet=validator_wallet,
        user_wallet=user_wallet,
        peer_manager=PeerManager(
            address, bootstrap, int(time.time()), opts.candidate_remove_threshold
        ),
        mpn_workers=dict(mpn_workers or {}),
    )
    return Node(ctx)


async def serve_http(node: Node, host: str, port: int):
    """Bridge real TCP to the node's request queue — a minimal HTTP/1.1
    server (stands in for the reference's hyper bridge,
    src/cli/mod.rs run_node)."""
    import json as _json
    from urllib.parse import parse_qs, urlparse

    async def client_connected(reader, writer):
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                parts = line.decode().strip().split(" ")
                if len(parts) < 2:
                    break
                method, target = parts[0], parts[1]
                headers = {}
                while True:
                    h = (await reader.readline()).decode().strip()
                    if not h:
                        break
                    k, _, v = h.partition(":")
                    headers[k.strip().lower()] = v.strip()
                body = b""
                if "content-length" in headers:
                    body = await reader.readexactly(int(headers["content-length"]))
                parsed = urlparse(target)
                query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
                peer_ip = writer.get_extra_info("peername")[0]
                req = NodeRequest(method, parsed.path, query, body, peer_ip)
                resp = await node.submit(req)
                payload = resp.body
                writer.write(
                    f"HTTP/1.1 {resp.status} OK\r\n"
                    f"content-type: application/json\r\n"
                    f"content-length: {len(payload)}\r\n\r\n".encode() + payload
                )
                await writer.drain()
                if headers.get("connection", "").lower() == "close":
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()

    server = await asyncio.start_server(client_connected, host, port)
    async with server:
        await server.serve_forever()


def http_sender(signer=None) -> OutgoingSender:
    """OutgoingSender doing real HTTP over asyncio sockets."""

    async def send(peer: PeerAddress, req: NodeRequest) -> NodeResponse:
        from urllib.parse import urlencode

        reader, writer = await asyncio.open_connection(peer.ip, peer.port)
        try:
            target = req.path + ("?" + urlencode(req.query) if req.query else "")
            head = (
                f"{req.method} {target} HTTP/1.1\r\n"
                f"host: {peer}\r\ncontent-length: {len(req.body)}\r\n"
                f"connection: close\r\n\r\n"
            )
            writer.write(head.encode() + req.body)
            await writer.drain()
            status_line = await reader.readline()
            status = int(status_line.split(b" ")[1])
            headers = {}
            while True:
                h = (await reader.readline()).decode().strip()
                if not h:
                    break
                k, _, v = h.partition(":")
                headers[k.strip().lower()] = v.strip()
            body = await reader.read()
            if "content-length" in headers:
                body = body[: int(headers["content-length"])]
            return NodeResponse(status, body)
        finally:
            writer.close()

    return OutgoingSender(send, signer)
