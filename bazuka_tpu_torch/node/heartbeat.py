"""The 8 heartbeat loops (reference: src/node/heartbeat/).
A copy of `bazuka_tpu/node/heartbeat.py`."""

from __future__ import annotations

import asyncio
import statistics

from ..client import Limit, NodeRequest, PeerAddress, from_hex, to_hex
from ..core import GeneralTransaction
from ..core.blocks import Block
from ..core.header import Header
from ..utils.logging import logger
from .peer_manager import Peer


async def make_loop(node, func, interval: float):
    while not node.context.shutdown:
        try:
            await func(node)
        except Exception as e:
            logger.error(f"Heartbeat error in {func.__name__}: {type(e).__name__}: {e}")
        await asyncio.sleep(interval)


async def heartbeater(node):
    ints = node.context.opts.heartbeat_intervals
    await asyncio.gather(
        make_loop(node, log_info, ints.log_info),
        make_loop(node, refresh, ints.refresh),
        make_loop(node, sync_peers, ints.sync_peers),
        make_loop(node, discover_peers, ints.discover_peers),
        make_loop(node, sync_clock, ints.sync_clock),
        make_loop(node, sync_blocks, ints.sync_blocks),
        make_loop(node, sync_mempool, ints.sync_mempool),
        make_loop(node, generate_block, ints.generate_block),
    )


async def log_info(node):
    ctx = node.context
    logger.info(
        f"Height: {ctx.blockchain.get_height()} | Nodes: {ctx.peer_manager.node_count()}"
        f" | Mempool: {len(ctx.mempool)}"
    )


async def refresh(node):
    node.context.refresh()
    node.context.on_update()


async def sync_peers(node):
    """Handshake with candidates; verified responders become nodes
    (reference: heartbeat/sync_peers.rs)."""
    ctx = node.context
    candidates = ctx.peer_manager.random_candidates(ctx.opts.num_peers)
    for addr in candidates:
        try:
            my = str(ctx.address) if ctx.address else "0.0.0.0:0"
            resp = await ctx.outgoing.json_post(
                addr, "/bincode/peers", {"address": my}, Limit(time=3.0)
            )
            if resp.get("info"):
                ctx.peer_manager.add_node(Peer.from_json(resp["info"]), 0.0)
        except Exception:
            ctx.punish_unresponsive(addr)
    ctx.peer_manager.select_peers(ctx.opts.num_peers)


async def discover_peers(node):
    """Ask peers for their peers (reference: heartbeat/discover_peers.rs)."""
    ctx = node.context
    now = ctx.local_timestamp()
    for peer in ctx.peer_manager.get_peers():
        try:
            resp = await ctx.outgoing.json_get(
                peer.address, "/peers", limit=Limit(time=3.0)
            )
            for p in resp.get("peers", []):
                ctx.peer_manager.add_candidate(now, PeerAddress.parse(p))
        except Exception:
            ctx.punish_unresponsive(peer.address)


async def sync_clock(node):
    """Set timestamp_offset to the median peer offset
    (reference: heartbeat/sync_clock.rs)."""
    ctx = node.context
    timestamps, corrections = [], []
    for peer in ctx.peer_manager.get_peers():
        try:
            resp = await ctx.outgoing.json_post(
                peer.address, "/bincode/peers",
                {"address": str(ctx.address) if ctx.address else "0.0.0.0:0"},
                Limit(time=3.0),
            )
            timestamps.append(resp["timestamp"])
            corrections.append(resp.get("timestamp_offset", 0))
        except Exception:
            pass
    if timestamps:
        # aim at the median RAW network clock: subtract the median of the
        # peers' own corrections so corrections don't feed back and drift
        # (reference: sync_clock.rs:54-61)
        ctx.timestamp_offset = int(
            statistics.median(timestamps)
            - ctx.local_timestamp()
            - statistics.median(corrections)
        )


async def sync_blocks(node):
    """Download headers/blocks from the most powerful peer; fork-choice by
    will_extend (reference: heartbeat/sync_blocks.rs)."""
    ctx = node.context
    peers = [p for p in ctx.peer_manager.get_peers()]
    peers.sort(key=lambda p: p.power, reverse=True)
    for peer in peers:
        if peer.power <= ctx.blockchain.get_power():
            return
        if (
            peer.height == ctx.blockchain.get_height() + 1
            and ctx.mpn_work_pool is not None
        ):
            logger.info("Syncing ignored! Validator is producing a block!")
            return
        local_height = ctx.blockchain.get_height()
        start_height = min(local_height, peer.height)
        try:
            resp = await ctx.outgoing.json_get(
                peer.address, "/bincode/headers",
                {"since": start_height, "count": ctx.opts.max_blocks_fetch},
                Limit(time=5.0),
            )
        except Exception:
            ctx.punish_unresponsive(peer.address)
            continue
        headers = [from_hex(Header, h) for h in resp["headers"]]
        if not headers:
            ctx.punish_bad_behavior(peer.address, ctx.opts.invalid_data_punish, "no headers")
            continue
        net_ts = ctx.network_timestamp()
        bad = False
        for i, head in enumerate(headers):
            if head.number != start_height + i:
                bad = True
                break
            if head.proof_of_stake.timestamp - net_ts > ctx.opts.max_block_time_difference:
                bad = True
                break
        if bad:
            ctx.punish_bad_behavior(peer.address, ctx.opts.invalid_data_punish, "bad headers")
            continue
        # find fork point
        fork_from = start_height
        while fork_from > 1:
            if headers and headers[0].parent_hash == ctx.blockchain.get_header(fork_from - 1).hash():
                break
            try:
                prev = await ctx.outgoing.json_get(
                    peer.address, "/bincode/headers",
                    {"since": fork_from - 1, "count": 1}, Limit(time=3.0),
                )
            except Exception:
                break
            prev_headers = [from_hex(Header, h) for h in prev["headers"]]
            if not prev_headers:
                break
            headers = prev_headers + headers
            fork_from -= 1
        try:
            if not ctx.blockchain.will_extend(fork_from, headers):
                ctx.punish_bad_behavior(
                    peer.address, ctx.opts.incorrect_chain_punish, "weaker chain"
                )
                continue
        except Exception:
            ctx.punish_bad_behavior(
                peer.address, ctx.opts.incorrect_chain_punish, "invalid chain"
            )
            continue
        try:
            blocks_resp = await ctx.outgoing.json_get(
                peer.address, "/bincode/blocks",
                {"since": fork_from, "count": len(headers)}, Limit(time=10.0),
            )
            blocks = [from_hex(Block, b) for b in blocks_resp["blocks"]]
            ctx.blockchain.extend(fork_from, blocks)
            ctx.on_update()
        except Exception as e:
            ctx.punish_bad_behavior(
                peer.address, ctx.opts.invalid_data_punish, f"bad blocks: {e}"
            )
        return


async def sync_mempool(node):
    """Pull peer mempools (reference: heartbeat/sync_mempool.rs)."""
    ctx = node.context
    for peer in ctx.peer_manager.get_peers():
        try:
            resp = await ctx.outgoing.json_get(
                peer.address, "/bincode/mempool", limit=Limit(time=5.0)
            )
        except Exception:
            ctx.punish_unresponsive(peer.address)
            continue
        for tx_hex in resp.get("txs", [])[: ctx.opts.mempool_max_fetch]:
            try:
                tx = from_hex(GeneralTransaction, tx_hex)
                ctx.mempool_add_tx(False, tx)
            except Exception:
                pass


async def generate_block(node):
    """VRF claim -> prepare MPN work pool -> poll -> draft + broadcast
    (reference: heartbeat/generate_block.rs)."""
    from ..mpn.workpool import prepare_works
    from .context import ValidatorClaim

    ctx = node.context
    ts = ctx.network_timestamp()
    proof = ctx.blockchain.validator_status(ts, ctx.validator_wallet)

    if proof is None and not ctx.blockchain.config.check_validator:
        # test chains: produce without election
        if ctx.opts.automatic_block_generation:
            draft = ctx.try_produce(ctx.validator_wallet)
            if draft is not None:
                await promote_block(node, draft)
        return

    if proof is not None:
        tip_es = ctx.blockchain.epoch_slot(
            ctx.blockchain.get_tip().proof_of_stake.timestamp
        )
        if ctx.blockchain.epoch_slot(ts) <= tip_es:
            return
        if ctx.address is None:
            return
        claim = ctx.validator_wallet.claim_validator(ts, proof, ctx.address)
        if ctx.update_validator_claim(claim) and ctx.opts.automatic_block_generation:
            cfg = ctx.blockchain.config.mpn_config
            validator_reward = ctx.blockchain.min_validator_reward(
                ctx.validator_wallet.get_address()
            )
            ctx.mpn_work_pool = prepare_works(
                cfg,
                ctx.blockchain,
                ctx.mpn_workers,
                [tx for tx, _ in ctx.mempool.mpn_deposits()],
                [tx for tx, _ in ctx.mempool.mpn_withdraws()],
                [tx for tx, _ in ctx.mempool.mpn_txs()],
                validator_reward,
                validator_reward // 100 * 5,
                validator_reward // 100 * 5,
                validator_reward // 100 * 15,
                ctx.blockchain.get_deposit_nonce(
                    ctx.validator_wallet.get_address(), cfg.mpn_contract_id
                ),
                ctx.validator_wallet,
                ctx.user_wallet,
            )
        if ctx.mpn_work_pool is not None:
            wallet = ctx.validator_wallet
            nonce = ctx.blockchain.get_nonce(wallet.get_address())
            td = ctx.mpn_work_pool.ready(wallet, nonce + 1)
            if td is not None:
                logger.info("All MPN-proofs ready!")
                from ..core import GeneralTransaction

                ctx.mempool_add_tx(True, GeneralTransaction(td))
                draft = ctx.try_produce(wallet)
                if draft is not None:
                    ctx.mpn_work_pool = None
                    ctx.validator_claim = None
                    await promote_block(node, draft)
        else:
            await promote_validator_claim(node, claim)
    else:
        # no longer elected: late-proof detection + claim invalidation
        if ctx.validator_claim is not None:
            if ctx.validator_claim.address == ctx.validator_wallet.get_address():
                if ctx.mpn_work_pool is not None:
                    for wid in ctx.mpn_work_pool.remaining_works():
                        logger.error(f"Solution for work {wid} is late!")
        ctx.mpn_work_pool = None
        if ctx.validator_claim is not None and not ctx.blockchain.is_validator(
            ts, ctx.validator_claim.address, ctx.validator_claim.proof
        ):
            ctx.validator_claim = None


async def promote_validator_claim(node, claim):
    """Gossip the winning claim (reference: src/node/mod.rs promote)."""
    from .api import claim_to_json

    ctx = node.context
    payload = {"claim": claim_to_json(claim)}
    for peer in ctx.peer_manager.get_peers():
        try:
            await ctx.outgoing.json_post(peer.address, "/claim", payload, Limit(time=3.0))
        except Exception:
            pass


async def promote_block(node, block: Block):
    """Broadcast a produced block to all peers
    (reference: src/node/mod.rs:88-107)."""
    ctx = node.context
    payload = {"block": to_hex(block)}
    for peer in ctx.peer_manager.get_peers():
        try:
            await ctx.outgoing.json_post(
                peer.address, "/bincode/blocks", payload, Limit(time=5.0)
            )
        except Exception:
            pass
