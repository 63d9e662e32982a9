"""HTTP API handlers + router (reference: src/node/mod.rs:221-417 and
src/node/api/).  JSON envelopes; chain objects as ser-hex blobs.
A copy of `bazuka_tpu/node/api.py`.
"""

from __future__ import annotations

import json
from typing import Optional

from ..client import NodeRequest, NodeResponse, from_hex, to_hex
from ..core import GeneralTransaction
from ..core.blocks import Block
from ..core.header import Header, ValidatorProof
from ..core.transaction import ContractId
from ..client import PeerAddress
from ..mpn.workpool import MpnWorker
from ..utils import ser
from .context import NodeContext, ValidatorClaim
from .peer_manager import Peer

VERSION = "bazuka-tpu-0.1"


def _json_resp(payload) -> NodeResponse:
    return NodeResponse(200, json.dumps(payload).encode())


# ---------------------------------------------------------------- handlers


async def get_stats(ctx: NodeContext, req):
    """(reference: src/node/api/get_stats.rs)."""
    b = ctx.blockchain
    return {
        "social_profiles": {},
        "address": str(ctx.address) if ctx.address else None,
        "height": b.get_height(),
        "nodes": ctx.peer_manager.node_count(),
        "power": b.get_power(),
        "next_reward": b.next_reward(),
        "timestamp": ctx.network_timestamp(),
        "timestamp_offset": ctx.timestamp_offset,
        "epoch": b.epoch_slot(ctx.network_timestamp())[0],
        "slot": b.epoch_slot(ctx.network_timestamp())[1],
        "version": VERSION,
        "network": ctx.network,
        "validator_claim": str(ctx.validator_claim.address)
        if ctx.validator_claim
        else None,
    }


async def get_account(ctx: NodeContext, req):
    from ..crypto.ed25519 import PublicKey

    addr = PublicKey.parse(req.query["address"])
    return {"nonce": ctx.blockchain.get_nonce(addr)}


async def get_balance(ctx: NodeContext, req):
    from ..crypto.ed25519 import PublicKey

    addr = PublicKey.parse(req.query["address"])
    token_id = ContractId.parse(req.query.get("token_id", "Ziesha"))
    token = ctx.blockchain.get_token(token_id)
    return {
        "balance": ctx.blockchain.get_balance(addr, token_id),
        "name": token.name if token else "Ziesha",
        "symbol": token.symbol if token else "ZSH",
    }


async def get_mpn_account(ctx: NodeContext, req):
    from ..core.address import MpnAddress

    acc = ctx.blockchain.get_mpn_account(MpnAddress.parse(req.query["address"]))
    return {
        "account": {
            "tx_nonce": acc.tx_nonce,
            "withdraw_nonce": acc.withdraw_nonce,
            "tokens": {
                str(i): {"token_id": str(m.token_id), "amount": m.amount}
                for i, m in acc.tokens.items()
            },
        }
    }


async def get_delegations(ctx: NodeContext, req):
    from ..crypto.ed25519 import PublicKey

    addr = PublicKey.parse(req.query["address"])
    top = int(req.query.get("top", "10"))
    return {
        "delegatees": dict(ctx.blockchain.get_delegatees(addr, top)),
        "delegators": dict(ctx.blockchain.get_delegators(addr, top)),
    }


async def get_token(ctx: NodeContext, req):
    token = ctx.blockchain.get_token(ContractId.parse(req.query["token_id"]))
    if token is None:
        return {"token": None}
    return {
        "token": {
            "name": token.name, "symbol": token.symbol,
            "supply": token.supply, "decimals": token.decimals,
        }
    }


async def get_headers(ctx: NodeContext, req):
    since = int(req.query["since"])
    count = min(int(req.query["count"]), ctx.opts.max_blocks_fetch)
    return {"headers": [to_hex(h) for h in ctx.blockchain.get_headers(since, count)]}


async def get_blocks(ctx: NodeContext, req):
    since = int(req.query["since"])
    count = min(int(req.query["count"]), ctx.opts.max_blocks_fetch)
    return {"blocks": [to_hex(b) for b in ctx.blockchain.get_blocks(since, count)]}


async def post_block(ctx: NodeContext, req):
    """(reference: src/node/api/post_block.rs promote flow)."""
    body = req.json()
    block = from_hex(Block, body["block"])
    height = ctx.blockchain.get_height()
    if block.header.number == height:
        ctx.blockchain.extend(height, [block])
        ctx.on_update()
    return {}


async def transact(ctx: NodeContext, req, is_local: bool):
    body = req.json()
    tx = from_hex(GeneralTransaction, body["tx"])
    ctx.mempool_add_tx(is_local, tx, body.get("claimed_timestamp", 0))
    return {}


async def get_check_tx(ctx: NodeContext, req):
    from ..core.transaction import Transaction

    tx = from_hex(Transaction, req.json()["tx"])
    try:
        ctx.blockchain.check_tx(tx)
        return {"error": None}
    except Exception as e:
        return {"error": type(e).__name__}


async def get_mempool(ctx: NodeContext, req):
    return {
        "txs": [to_hex(tx) for tx, _ in ctx.mempool.all()],
    }


async def get_peers(ctx: NodeContext, req):
    return {"peers": [str(p.address) for p in ctx.peer_manager.get_nodes()]}


async def post_peer(ctx: NodeContext, req):
    """Handshake: register the caller as a candidate, return our info
    (reference: src/node/api/post_peer.rs)."""
    body = req.json()
    addr = PeerAddress.parse(body["address"])
    ctx.peer_manager.add_candidate(ctx.local_timestamp(), addr)
    info = ctx.get_info()
    # network timestamp + the correction it contains, so sync_clock can
    # recover the peer's RAW clock (reference: post_peer.rs:31-32)
    return {
        "info": info.to_json() if info else None,
        "timestamp": ctx.network_timestamp(),
        "timestamp_offset": ctx.timestamp_offset,
    }


async def shutdown(ctx: NodeContext, req):
    ctx.shutdown = True
    return {}


async def post_validator_claim(ctx: NodeContext, req):
    body = req.json()
    claim = claim_from_json(body["claim"])
    accepted = ctx.update_validator_claim(claim)
    return {"accepted": accepted}


async def get_mpn_work(ctx: NodeContext, req):
    """(reference: src/node/api/get_mpn_work.rs)."""
    from ..crypto.ed25519 import PublicKey

    addr = PublicKey.parse(req.query["address"])
    if ctx.mpn_work_pool is None:
        return {"works": {}}
    works = ctx.mpn_work_pool.get_works(addr)
    return {
        "works": {
            str(i): {
                "kind": w.data_kind,
                "height": w.public_inputs.height,
                "state": hex(w.public_inputs.state),
                "aux_data": hex(w.public_inputs.aux_data),
                "next_state": hex(w.public_inputs.next_state),
                "reward": w.reward,
            }
            for i, w in works.items()
        }
    }


async def post_mpn_solution(ctx: NodeContext, req):
    """(reference: src/node/api/post_mpn_solution.rs)."""
    from ..crypto.ed25519 import PublicKey
    from ..zk.proof import ZkProof

    body = req.json()
    prover = PublicKey.parse(body["address"])
    accepted = 0
    if ctx.mpn_work_pool is not None:
        for wid, proof_hex in body["proofs"].items():
            proof = from_hex(ZkProof, proof_hex)
            if ctx.mpn_work_pool.prove(int(wid), prover, proof):
                accepted += 1
    return {"accepted": accepted}


async def post_mpn_worker(ctx: NodeContext, req):
    """(reference: src/node/api/post_mpn_worker.rs)."""
    from ..crypto.ed25519 import PublicKey

    addr = PublicKey.parse(req.json()["address"])
    ctx.mpn_workers[str(addr)] = MpnWorker(addr)
    return {"accepted": True}


async def get_explorer_blocks(ctx: NodeContext, req):
    """Full JSON block mirrors (reference: src/client/explorer.rs)."""
    from .explorer import block_to_json

    since = int(req.query.get("since", "0"))
    count = min(int(req.query.get("count", "10")), 100)
    return {
        "blocks": [block_to_json(b) for b in ctx.blockchain.get_blocks(since, count)]
    }


async def get_explorer_stakers(ctx: NodeContext, req):
    return {"stakers": [{"address": a, "stake": s} for a, s in ctx.blockchain.get_stakers()]}


async def get_explorer_mempool(ctx: NodeContext, req):
    """Typed full-detail mempool view (reference: get_explorer_mempool.rs
    over ExplorerGeneralTransaction)."""
    from .explorer import general_tx_to_json

    return {"mempool": [general_tx_to_json(tx) for tx, _ in ctx.mempool.all()]}


async def get_explorer_mpn_accounts(ctx: NodeContext, req):
    page = int(req.query.get("page", "0"))
    page_size = min(int(req.query.get("page_size", "25")), 100)
    accs = ctx.blockchain.get_mpn_accounts(page, page_size)
    return {
        "accounts": [
            {
                "index": i,
                "tx_nonce": a.tx_nonce,
                "withdraw_nonce": a.withdraw_nonce,
                "address": [hex(a.address[0]), hex(a.address[1])],
                "tokens": {str(k): m.amount for k, m in a.tokens.items()},
            }
            for i, a in accs
        ]
    }


async def get_debug_data(ctx: NodeContext, req):
    return {
        "height": ctx.blockchain.get_height(),
        "db_checksum": ctx.blockchain.db_checksum(),
        "mempool_len": len(ctx.mempool),
    }


async def get_logs(ctx: NodeContext, req):
    from ..utils.logging import GLOBAL_LOGS

    return {"logs": list(GLOBAL_LOGS)}


# ---------------------------------------------------------------- claims


def claim_to_json(claim: ValidatorClaim):
    w = ser.Writer()
    claim.proof.write_to(w)
    return {
        "timestamp": claim.timestamp,
        "address": str(claim.address),
        "proof": w.getvalue().hex(),
        "node": str(claim.node),
        "sig": claim.sig.hex() if claim.sig else None,
    }


def claim_from_json(d) -> ValidatorClaim:
    from ..crypto.ed25519 import PublicKey

    proof = ValidatorProof.read_from(ser.Reader(bytes.fromhex(d["proof"])))
    return ValidatorClaim(
        timestamp=d["timestamp"],
        address=PublicKey.parse(d["address"]),
        proof=proof,
        node=PeerAddress.parse(d["node"]),
        sig=bytes.fromhex(d["sig"]) if d.get("sig") else None,
    )


# ---------------------------------------------------------------- router

ROUTES = {
    ("GET", "/stats"): get_stats,
    ("GET", "/account"): get_account,
    ("GET", "/balance"): get_balance,
    ("GET", "/mpn/account"): get_mpn_account,
    ("GET", "/delegations"): get_delegations,
    ("GET", "/token"): get_token,
    ("GET", "/peers"): get_peers,
    ("GET", "/mempool"): get_mempool,
    ("GET", "/bincode/mempool"): get_mempool,
    ("GET", "/bincode/headers"): get_headers,
    ("GET", "/bincode/blocks"): get_blocks,
    ("POST", "/bincode/blocks"): post_block,
    ("POST", "/bincode/peers"): post_peer,
    ("GET", "/bincode/transact/check"): get_check_tx,
    ("POST", "/claim"): post_validator_claim,
    ("GET", "/bincode/mpn/work"): get_mpn_work,
    ("POST", "/bincode/mpn/solution"): post_mpn_solution,
    ("POST", "/bincode/mpn/worker"): post_mpn_worker,
    ("GET", "/explorer/blocks"): get_explorer_blocks,
    ("GET", "/explorer/stakers"): get_explorer_stakers,
    ("GET", "/explorer/mempool"): get_explorer_mempool,
    ("GET", "/explorer/mpn/accounts"): get_explorer_mpn_accounts,
    ("GET", "/debug"): get_debug_data,
    ("GET", "/logs"): get_logs,
}


async def node_service(ctx: NodeContext, req: NodeRequest, is_local: bool) -> NodeResponse:
    key = (req.method, req.path)
    if key == ("POST", "/shutdown"):
        if not is_local:
            return NodeResponse(403, b"{}")
        return _json_resp(await shutdown(ctx, req))
    if key == ("POST", "/generate_block"):
        # test-only block production trigger (reference: src/node/mod.rs:221-226)
        if not is_local:
            return NodeResponse(403, b"{}")
        draft = ctx.try_produce(ctx.validator_wallet)
        return _json_resp({"produced": draft is not None})
    if key in (("POST", "/bincode/transact"), ("POST", "/transact/zero")):
        return _json_resp(await transact(ctx, req, is_local))
    handler = ROUTES.get(key)
    if handler is None:
        return NodeResponse(404, b"{}")
    return _json_resp(await handler(ctx, req))
