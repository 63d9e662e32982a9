"""The port's node, client and explorer (`node/`, `client/`) against the
JAX package's.

- Each case of tests/test_node.py (peer discovery, block sync, the drop,
  delay and redirect rules, mempool propagation, the API surface, a
  refused remote shutdown, the transact endpoint, the clock's median
  under skew) and of tests/test_consensus.py (three VRF-elected
  validators producing and syncing blocks) on the port's `Simulation`.
- Every route of the JAX package's route table, and `/shutdown`,
  `/generate_block`, `/bincode/transact` and an unknown path, give the
  same status and JSON body in both packages for the same chain state,
  mempool, work pool, peers and clock: the explorer's views key for key,
  the work pool's works, solutions and workers, a VRF claim; `/logs`
  shows each package's own lines only.
- The explorer's views of the test genesis block, of every mempool kind
  and of the MPN state model are the JAX package's (tests/test_explorer.py).
- `TxBuilder.claim_validator`'s signing bytes and signature are equal in
  both packages, and its JSON form round-trips in either.
- A mixed network: one JAX node and one port node wired by a router that
  converts `NodeRequest` and `NodeResponse` between the packages.  A block
  made by either is synced by the other (the port's through `sync_blocks`,
  the JAX node's through `promote_block`), a transaction sent to one
  reaches the other's mempool, and both end at the same height and
  `db_checksum`.
"""

import asyncio
import importlib
import json
import random
import time
import types

import pytest
import torch

from bazuka_tpu.zk import proof as jzkproof
from chip_smoke import until
from bazuka_tpu_torch.zk import proof as zkproof

torch.set_num_threads(1)


def lib(pkg: str):
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    tr = mod("core.transaction")
    return types.SimpleNamespace(
        pkg=pkg, client=mod("client"), node=mod("node"), api=mod("node.api"),
        sim=mod("node.simulation"), explorer=mod("node.explorer"),
        context=mod("node.context"), peers=mod("node.peer_manager"),
        heartbeat=mod("node.heartbeat"),
        logging=mod("utils.logging"), cfg=mod("config.blockchain"), tr=tr,
        core=mod("core"), Money=tr.Money, ContractId=tr.ContractId,
        KvStoreChain=mod("blockchain").KvStoreChain,
        RamKvStore=mod("db").RamKvStore,
        TxBuilder=mod("wallet.tx_builder").TxBuilder,
        wp=mod("mpn.workpool"), ZkProof=mod("zk.proof").ZkProof,
        ser=mod("utils.ser"))


PORT, JAX = lib("bazuka_tpu_torch"), lib("bazuka_tpu")


@pytest.fixture(autouse=True)
def dummy_proofs_restored():
    saved = zkproof._ALLOW_DUMMY, jzkproof._ALLOW_DUMMY
    yield
    zkproof._ALLOW_DUMMY, jzkproof._ALLOW_DUMMY = saved


def run(coro):
    return asyncio.get_event_loop_policy().new_event_loop().run_until_complete(
        coro)


def make_sim(m, n=2, rules=()):
    sim = m.sim.Simulation()
    conf = m.cfg.get_test_blockchain_config()
    for i in range(n):
        sim.add_node(3030 + i, conf,
                     bootstrap=[3030 + j for j in range(n) if j != i])
    sim.rules.extend(rules)
    return sim


def produce(m, node, ts=10):
    """A block by b"VALIDATOR" applied to `node`'s chain before the
    network starts."""
    chain = node.context.blockchain
    chain.apply_block(chain.draft_block(ts, [], m.TxBuilder(b"VALIDATOR"),
                                        check=True))
    return chain


# ------------------------------------------- tests/test_node.py, test_consensus.py


async def case_peers_discover_each_other(m):
    sim = make_sim(m, 3)
    await sim.start()
    try:
        await m.sim.catch_change(lambda: all(
            n.context.peer_manager.node_count() >= 2
            for n in sim.nodes.values()), timeout=15.0)
    finally:
        await sim.stop()
    assert all(n.context.peer_manager.node_count() >= 2
               for n in sim.nodes.values())


async def case_blocks_sync_between_nodes(m):
    sim = make_sim(m, 2)
    n0, n1 = sim.nodes[3030], sim.nodes[3031]
    produce(m, n0)
    assert (n0.context.blockchain.get_height(),
            n1.context.blockchain.get_height()) == (2, 1)
    await sim.start()
    try:
        await m.sim.catch_change(lambda: n1.context.blockchain.get_height(),
                                 timeout=15.0)
    finally:
        await sim.stop()
    assert n1.context.blockchain.get_height() == 2
    assert (n1.context.blockchain.get_tip().hash()
            == n0.context.blockchain.get_tip().hash())


async def case_drop_rule_blocks_sync(m):
    sim = make_sim(m, 2, [m.sim.Rule("drop", path="/bincode/headers")])
    n1 = sim.nodes[3031]
    produce(m, sim.nodes[3030])
    await sim.start()
    await asyncio.sleep(2.0)
    await sim.stop()
    assert n1.context.blockchain.get_height() == 1


async def case_mempool_propagates(m):
    sim = make_sim(m, 2)
    n0, n1 = sim.nodes[3030], sim.nodes[3031]
    abc, bob = m.TxBuilder(b"ABC"), m.TxBuilder(b"BOB")
    td = abc.create_transaction("", bob.get_address(), m.Money.ziesha(10),
                                m.Money.ziesha(1), 1)
    n0.context.mempool.min_balance_per_tx = 1
    n1.context.mempool.min_balance_per_tx = 1
    n0.context.mempool_add_tx(True, m.core.GeneralTransaction(td))
    assert len(n0.context.mempool) == 1
    await sim.start()
    try:
        await m.sim.catch_change(lambda: len(n1.context.mempool), timeout=15.0)
    finally:
        await sim.stop()
    assert len(n1.context.mempool) == 1


async def case_api_surface(m):
    sim = make_sim(m, 1)
    await sim.start()
    try:
        sender = sim.sender("127.0.0.1")
        peer = m.client.PeerAddress("10.0.0.1", 3030)
        stats = await sender.json_get(peer, "/stats")
        assert stats["height"] == 1 and stats["network"] == "sim"
        abc = m.TxBuilder(b"ABC")
        bal = await sender.json_get(peer, "/balance", {
            "address": str(abc.get_address()), "token_id": "Ziesha"})
        assert bal["balance"] == 10000
        acct = await sender.json_get(peer, "/account",
                                     {"address": str(abc.get_address())})
        assert acct["nonce"] == 0
        expl = await sender.json_get(peer, "/explorer/blocks",
                                     {"since": 0, "count": 5})
        assert len(expl["blocks"]) == 1
        stakers = await sender.json_get(peer, "/explorer/stakers")
        assert len(stakers["stakers"]) == 3
        assert (await sender.json_get(peer, "/debug"))["height"] == 1
        missing = await sender.request(
            peer, m.client.NodeRequest("GET", "/nonexistent"))
        assert missing.status == 404
    finally:
        await sim.stop()


async def case_shutdown_forbidden_remotely(m):
    sim = make_sim(m, 1)
    await sim.start()
    try:
        resp = await sim.sender("9.9.9.9").request(
            m.client.PeerAddress("10.0.0.1", 3030),
            m.client.NodeRequest("POST", "/shutdown"))
        assert resp.status == 403
        assert not sim.nodes[3030].context.shutdown
    finally:
        await sim.stop()


async def case_transact_endpoint(m):
    sim = make_sim(m, 1)
    node = sim.nodes[3030]
    node.context.mempool.min_balance_per_tx = 1
    await sim.start()
    try:
        abc, bob = m.TxBuilder(b"ABC"), m.TxBuilder(b"BOB")
        td = abc.create_transaction("", bob.get_address(), m.Money.ziesha(5),
                                    m.Money.ziesha(1), 1)
        await sim.sender("127.0.0.1").json_post(
            m.client.PeerAddress("10.0.0.1", 3030), "/bincode/transact",
            {"tx": m.client.to_hex(m.core.GeneralTransaction(td))})
        assert len(node.context.mempool) == 1
    finally:
        await sim.stop()


async def case_delay_rule_slows_but_allows_sync(m):
    sim = make_sim(m, 2, [m.sim.Rule("delay", delay=0.3)])
    n1 = sim.nodes[3031]
    produce(m, sim.nodes[3030])
    await sim.start()
    try:
        await m.sim.catch_change(lambda: n1.context.blockchain.get_height(),
                                 timeout=20.0)
    finally:
        await sim.stop()
    assert n1.context.blockchain.get_height() == 2


async def case_redirect_rule_syncs_from_other_node(m):
    sim = m.sim.Simulation()
    conf = m.cfg.get_test_blockchain_config()
    sim.add_node(3030, conf, bootstrap=[])
    sim.add_node(3031, conf, bootstrap=[3030])
    sim.add_node(3032, conf, bootstrap=[])
    sim.rules.append(m.sim.Rule("redirect", port=3030, redirect_to=3032))
    n1, n2 = sim.nodes[3031], sim.nodes[3032]
    produce(m, n2)
    await sim.start()
    try:
        await m.sim.catch_change(lambda: n1.context.blockchain.get_height(),
                                 timeout=20.0)
    finally:
        await sim.stop()
    assert n1.context.blockchain.get_height() == 2
    assert (n1.context.blockchain.get_tip().hash()
            == n2.context.blockchain.get_tip().hash())


async def case_clock_syncs_to_median_under_skew(m):
    sim = make_sim(m, 3, [m.sim.Rule("delay", delay=0.1, path="/bincode/peers")])
    skewed = sim.nodes[3030]
    skewed.context.clock_skew = -100
    await sim.start()
    try:
        await m.sim.catch_change(
            lambda: abs(skewed.context.timestamp_offset - 100) <= 3,
            timeout=20.0)
    finally:
        await sim.stop()
    assert abs(skewed.context.timestamp_offset - 100) <= 3


async def case_automatic_block_production_with_election(m):
    # tests/test_consensus.py
    conf = m.cfg.get_test_blockchain_config()
    conf.check_validator = True
    sim = m.sim.Simulation()
    opts = m.node.get_simulator_options()
    opts.automatic_block_generation = True
    for i, seed in enumerate((b"VALIDATOR", b"VALIDATOR2", b"VALIDATOR3")):
        sim.add_node(3060 + i, conf,
                     bootstrap=[3060 + j for j in range(3) if j != i],
                     seed=seed, opts=opts)
    await sim.start()
    try:
        heights = lambda: max(  # noqa: E731
            n.context.blockchain.get_height() for n in sim.nodes.values())
        await m.sim.catch_change(heights, timeout=30.0)
        assert heights() >= 2
        await m.sim.catch_change(lambda: min(
            n.context.blockchain.get_height() for n in sim.nodes.values()),
            timeout=30.0)
    finally:
        await sim.stop()
    assert max(n.context.blockchain.get_height()
               for n in sim.nodes.values()) >= 2


CASES = [name for name in globals() if name.startswith("case_")]


@pytest.mark.parametrize("case", CASES)
def test_node_case_on_the_port(case):
    run(globals()[case](PORT))


# ------------------------------------------------------------ route parity


FIXED_NOW = 66  # both nodes' clock in the route-parity test: VALIDATOR is elected


def parity_node(m):
    """A node of package `m` over the test chain after one block (a send),
    with a mempool (a send, an MPN deposit), a work pool of one batch of
    each kind, one verified peer and the clock at FIXED_NOW."""
    conf = m.cfg.get_test_blockchain_config()
    chain = m.KvStoreChain(m.RamKvStore(), conf)
    abc, bob = m.TxBuilder(b"ABC"), m.TxBuilder(b"BOB")
    val = m.TxBuilder(b"VALIDATOR")
    z = m.Money.ziesha
    chain.apply_block(chain.draft_block(10, [abc.create_transaction(
        "", bob.get_address(), z(100), z(5), 1)], val, check=True))

    async def nowhere(peer, req):
        raise ConnectionError("no network")

    node = m.node.node_create(
        m.node.get_simulator_options(), "sim",
        m.client.PeerAddress("10.0.0.1", 3030), [], chain,
        (val, m.TxBuilder(b"VALIDATOR-user")),
        m.client.OutgoingSender(nowhere))
    ctx = node.context
    ctx.mempool.min_balance_per_tx = 1
    cid = conf.mpn_config.mpn_contract_id
    ctx.mempool_add_tx(True, m.core.GeneralTransaction(abc.create_transaction(
        "", bob.get_address(), z(7), z(2), 2)))
    ctx.mempool_add_tx(True, m.core.GeneralTransaction(abc.deposit_mpn(
        "", cid, abc.get_mpn_address(), 1, z(500), z(0))))
    mc = conf.mpn_config
    pool_conf = type(mc)(**{**vars(mc), "mpn_num_deposit_batches": 1,
                            "mpn_num_withdraw_batches": 1,
                            "mpn_num_update_batches": 1})
    ctx.mpn_work_pool = m.wp.prepare_works(
        pool_conf, chain, {}, [tx for tx, _ in ctx.mempool.mpn_deposits()],
        [], [], 1000, 50, 50, 150,
        chain.get_deposit_nonce(val.get_address(), cid), val, val)
    ctx.peer_manager.add_node(m.peers.Peer(
        m.client.PeerAddress("10.0.0.9", 3039), 2, 2.0,
        str(m.TxBuilder(b"VALIDATOR2").get_address())), 0.0)
    ctx.peer_manager.select_peers(8)
    return node


def parity_requests(m, chain):
    """(method, path, query, body, client ip) of every route, in order;
    the later ones change the state the earlier ones read."""
    abc, val = m.TxBuilder(b"ABC"), m.TxBuilder(b"VALIDATOR")
    worker = m.TxBuilder(b"WORKER")
    z = m.Money.ziesha
    ts = FIXED_NOW
    proof = chain.validator_status(ts, val)
    claim = val.claim_validator(ts, proof,
                                m.client.PeerAddress("10.0.0.1", 3030))
    nxt = chain.draft_block(45, [], val, check=True)
    tx = abc.create_transaction("", val.get_address(), z(3), z(1), 2)
    local, remote = None, "10.0.0.7"
    a = {"address": str(abc.get_address())}
    return [
        ("GET", "/stats", {}, b"", local),
        ("GET", "/account", a, b"", local),
        ("GET", "/balance", {**a, "token_id": "Ziesha"}, b"", local),
        ("GET", "/mpn/account", {"address": str(abc.get_mpn_address())},
         b"", local),
        ("GET", "/delegations", {"address": str(val.get_address())}, b"",
         local),
        ("GET", "/token", {"token_id": "Ziesha"}, b"", local),
        ("GET", "/peers", {}, b"", local),
        ("GET", "/mempool", {}, b"", local),
        ("GET", "/bincode/mempool", {}, b"", remote),
        ("GET", "/bincode/headers", {"since": "0", "count": "5"}, b"", remote),
        ("GET", "/bincode/blocks", {"since": "1", "count": "5"}, b"", remote),
        ("POST", "/bincode/peers", {}, json.dumps(
            {"address": "10.0.0.7:3037"}).encode(), remote),
        ("GET", "/bincode/transact/check", {}, json.dumps(
            {"tx": m.client.to_hex(tx.tx)}).encode(), local),
        ("POST", "/claim", {}, json.dumps(
            {"claim": m.api.claim_to_json(claim)}).encode(), remote),
        ("POST", "/bincode/mpn/worker", {}, json.dumps(
            {"address": str(worker.get_address())}).encode(), local),
        ("GET", "/bincode/mpn/work", {"address": str(worker.get_address())},
         b"", local),
        ("POST", "/bincode/mpn/solution", {}, json.dumps({
            "address": str(worker.get_address()), "proofs": {
                "0": m.client.to_hex(m.ZkProof.dummy(True)),
                "1": m.client.to_hex(m.ZkProof.dummy(False)),
                "2": m.client.to_hex(m.ZkProof.dummy(True))}}).encode(),
         local),
        ("GET", "/explorer/blocks", {"since": "0", "count": "3"}, b"", local),
        ("GET", "/explorer/stakers", {}, b"", local),
        ("GET", "/explorer/mempool", {}, b"", local),
        ("GET", "/explorer/mpn/accounts", {"page": "0", "page_size": "5"},
         b"", local),
        ("GET", "/debug", {}, b"", local),
        ("GET", "/logs", {}, b"", local),
        ("POST", "/bincode/blocks", {}, json.dumps(
            {"block": m.client.to_hex(nxt)}).encode(), remote),
        ("POST", "/bincode/transact", {}, json.dumps(
            {"tx": m.client.to_hex(m.core.GeneralTransaction(tx))}).encode(),
         remote),
        ("POST", "/generate_block", {}, b"", remote),
        ("POST", "/generate_block", {}, b"", local),
        ("GET", "/debug", {}, b"", local),
        ("GET", "/nonexistent", {}, b"", local),
        ("POST", "/shutdown", {}, b"", remote),
        ("POST", "/shutdown", {}, b"", local),
    ]


def route_answers(m):
    random.seed(12)
    node = parity_node(m)
    m.logging.GLOBAL_LOGS.clear()
    m.logging.logger.info("route parity")
    reqs = parity_requests(m, node.context.blockchain)
    out = []
    for method, path, query, body, ip in reqs:
        resp = run(node.handle(m.client.NodeRequest(method, path, query, body,
                                                    ip)))
        payload = resp.json()
        if path == "/logs":  # "<date> <time> INFO ...": the time varies
            payload = [line.split(" ", 2)[2] for line in payload["logs"]]
        out.append((method, path, ip, resp.status, payload))
    return out, node


def test_every_route_equals_jax(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: float(FIXED_NOW))
    port, pnode = route_answers(PORT)
    jax, jnode = route_answers(JAX)
    assert len(port) == len(jax)
    for p, j in zip(port, jax):
        assert p == j, p[:3]
    routes = {(r[0], r[1]) for r in port}
    assert set(PORT.api.ROUTES) == set(JAX.api.ROUTES) <= routes
    answers = {(r[0], r[1], r[2]): r[3:] for r in port}
    assert answers[("POST", "/shutdown", "10.0.0.7")][0] == 403
    assert answers[("POST", "/shutdown", None)] == (200, {})
    assert answers[("POST", "/generate_block", None)] == (
        200, {"produced": True})
    assert answers[("GET", "/nonexistent", None)][0] == 404
    assert answers[("POST", "/claim", "10.0.0.7")] == (200, {"accepted": True})
    assert answers[("POST", "/bincode/mpn/solution", None)] == (
        200, {"accepted": 2})
    assert answers[("GET", "/logs", None)] == (200, ["INFO route parity"])
    assert pnode.context.shutdown and jnode.context.shutdown
    blocks = answers[("GET", "/explorer/blocks", None)][1]["blocks"]
    assert [b["header"]["number"] for b in blocks] == [0, 1]
    assert pnode.context.blockchain.db_checksum() == \
        jnode.context.blockchain.db_checksum()
    assert pnode.context.blockchain.get_height() == 4


def test_logs_are_each_packages_own():
    for m in (PORT, JAX):
        m.logging.GLOBAL_LOGS.clear()
    PORT.logging.logger.info("port line")
    JAX.logging.logger.info("jax line")
    assert PORT.logging.logger.name == "bazuka_tpu_torch"
    assert [x.split(" ", 2)[2] for x in PORT.logging.GLOBAL_LOGS] == [
        "INFO port line"]
    assert [x.split(" ", 2)[2] for x in JAX.logging.GLOBAL_LOGS] == [
        "INFO jax line"]


def test_explorer_views_equal_jax():
    # tests/test_explorer.py's views in both packages
    views = []
    for m in (PORT, JAX):
        conf = m.cfg.get_test_blockchain_config()
        alice = m.TxBuilder(b"ALICE")
        cid, z = m.ContractId(7), m.Money.ziesha
        gts = [m.core.GeneralTransaction(t) for t in (
            alice.deposit_mpn("m", cid, alice.get_mpn_address(), 1, z(10),
                              z(1)),
            alice.create_mpn_transaction(alice.get_mpn_address(), z(5), z(1),
                                         1),
            alice.withdraw_mpn("m", cid, 1, z(5), z(1), alice.get_address()),
            alice.create_transaction("", alice.get_address(), z(3), z(1), 1))]
        model = importlib.import_module(f"{m.pkg}.mpn.config").MpnConfig(
            3, 1, 1, 1, 1, m.ContractId.NULL).state_model()
        views.append(json.dumps([
            m.explorer.block_to_json(conf.genesis),
            [m.explorer.general_tx_to_json(gt) for gt in gts],
            m.explorer.state_model_to_json(model)], sort_keys=False))
    assert views[0] == views[1]
    genesis, txs, model = json.loads(views[0])
    assert genesis["header"]["number"] == 0 and model["List"]["log4_size"] == 3
    assert [list(v)[0] for v in txs] == [
        "MpnDeposit", "MpnTransaction", "MpnWithdraw", "TransactionAndDelta"]


def test_claim_validator_equals_jax():
    out = []
    for m in (PORT, JAX):
        conf = m.cfg.get_test_blockchain_config()
        chain = m.KvStoreChain(m.RamKvStore(), conf)
        val = m.TxBuilder(b"VALIDATOR")
        ts = next(t for t in range(10, 200)
                  if chain.validator_status(t, val) is not None)
        proof = chain.validator_status(ts, val)
        claim = val.claim_validator(ts, proof,
                                    m.client.PeerAddress("10.0.0.1", 3030))
        assert isinstance(claim, m.context.ValidatorClaim)
        assert claim.verify_signature()
        back = m.api.claim_from_json(json.loads(json.dumps(
            m.api.claim_to_json(claim))))
        assert back == claim and back.verify_signature()
        claim.timestamp += 1
        assert not claim.verify_signature()
        claim.timestamp -= 1
        out.append((ts, claim.signing_bytes(), claim.sig,
                    m.api.claim_to_json(claim)))
    assert out[0] == out[1]


# ----------------------------------------------------------- mixed network


class MixedRouter:
    """Nodes of either package at ports; each request goes to its port's
    node as that package's `NodeRequest`, and its answer comes back as
    the sender's `NodeResponse`."""

    def __init__(self):
        self.nodes = {}  # port -> (package, Node)

    def sender(self, m, from_ip: str):
        async def send(peer, req):
            tm, node = self.nodes[peer.port]
            resp = await node.submit(tm.client.NodeRequest(
                req.method, req.path, dict(req.query), req.body, from_ip))
            return m.client.NodeResponse(resp.status, resp.body)
        return m.client.OutgoingSender(send)

    def add(self, m, port: int, peer_port: int, seed: bytes):
        ip, peer_ip = f"10.0.0.{port % 250 + 1}", f"10.0.0.{peer_port % 250 + 1}"
        node = m.node.node_create(
            m.node.get_simulator_options(), "sim",
            m.client.PeerAddress(ip, port),
            [m.client.PeerAddress(peer_ip, peer_port)],
            m.KvStoreChain(m.RamKvStore(), m.cfg.get_test_blockchain_config()),
            (m.TxBuilder(seed), m.TxBuilder(seed + b"-user")),
            self.sender(m, ip))
        node.context.mempool.min_balance_per_tx = 1
        self.nodes[port] = (m, node)
        return node


def test_mixed_network_syncs_both_ways():
    async def body():
        router = MixedRouter()
        pn = router.add(PORT, 3030, 3031, b"VALIDATOR")
        jn = router.add(JAX, 3031, 3030, b"VALIDATOR2")
        pchain, jchain = pn.context.blockchain, jn.context.blockchain
        assert pchain.db_checksum() == jchain.db_checksum()
        abc, bob = PORT.TxBuilder(b"ABC"), PORT.TxBuilder(b"BOB")
        z = PORT.Money.ziesha
        pchain.apply_block(pchain.draft_block(10, [abc.create_transaction(
            "", bob.get_address(), z(100), z(5), 1)], pn.context.validator_wallet,
            check=True))
        tasks = [asyncio.create_task(n.run()) for _, n in router.nodes.values()]
        try:
            # the port's block reaches the JAX node
            await until(lambda: jchain.get_height() == 2, 15.0)
            assert jchain.get_tip().hash() == pchain.get_tip().hash()
            # a transaction sent to the JAX node reaches the port's mempool
            jabc, jbob = JAX.TxBuilder(b"ABC"), JAX.TxBuilder(b"BOB")
            td = jabc.create_transaction("", jbob.get_address(),
                                         JAX.Money.ziesha(7),
                                         JAX.Money.ziesha(1), 2)
            jn.context.mempool_add_tx(True, JAX.core.GeneralTransaction(td))
            await until(lambda: len(pn.context.mempool) == 1, 15.0)
            # the JAX node's block, with that transaction, promoted to the
            # port as its heartbeat promotes a block it made
            blk = jchain.draft_block(20, [td], jn.context.validator_wallet,
                                     check=True)
            jchain.extend(blk.header.number, [blk])
            jn.context.on_update()
            await JAX.heartbeat.promote_block(jn, blk)
            await until(lambda: pchain.get_height() == 3, 15.0)
            await until(lambda: len(pn.context.mempool) == 0, 15.0)
        finally:
            for _, n in router.nodes.values():
                n.context.shutdown = True
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
        assert pchain.get_height() == jchain.get_height() == 3
        assert pchain.get_tip().hash() == jchain.get_tip().hash()
        assert pchain.db_checksum() == jchain.db_checksum()
        assert len(pn.context.mempool) == len(jn.context.mempool) == 0
        assert pchain.get_balance(bob.get_address(),
                                  PORT.ContractId.ZIESHA) == 107

    run(body())
