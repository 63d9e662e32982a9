"""The port's MPN work pool (`mpn/workpool.py`) and the node's block
production on its chain, against the JAX package's.

The two blocks of `chip_smoke.py`'s `devchain` phase (`DevChain`: users
deposit in block 1; in block 2 they pay each other and half of them
withdraw; the validator's reward self-deposit rides each deposit batch)
run on the test chain at log4 (3, 1, 1) with one batch of each kind and
dummy proofs, in both packages: each work's public inputs, transitions and
reward, the pool's `extract_delta`, the `ready` transaction's bytes and
hash, both block hashes and the `db_checksum` after each block are equal;
the balances and rewards are those of the construction; a failing dummy
proof is refused by the pool (tests/test_mpn_pipeline.py:88) and, inside
a block, by `apply_block`.  Work assignment (`get_works`, which draws
from `random`) is equal under one seed.  The JAX chain's state after block
1, carried pair by pair into the port's `RamKvStore`, reads the same and
takes the JAX block 2 to the JAX checksum.

Slow tier: `get_dev_blockchain_config(3, 1, 1, device="cpu")` gives the
JAX package's three VKs at the same seed, and a dev-chain block whose
three works the port proves on the CPU under those keys is accepted.
"""

import dataclasses
import importlib
import random
import types

import pytest
import torch

import chip_smoke
from bazuka_tpu.zk import proof as jzkproof
from bazuka_tpu_torch.zk import proof as zkproof

torch.set_num_threads(1)


def lib(pkg: str):
    """A package's names that `chip_smoke.DevChain` uses, and its config
    builders and work pool module."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    tr, wp = mod("core.transaction"), mod("mpn.workpool")
    return types.SimpleNamespace(
        KvStoreChain=mod("blockchain").KvStoreChain,
        RamKvStore=mod("db").RamKvStore, db=mod("db"),
        TxBuilder=mod("wallet.tx_builder").TxBuilder, Money=tr.Money,
        ContractId=tr.ContractId, Ratio=mod("core.money").Ratio,
        MpnWorker=wp.MpnWorker, prepare_works=wp.prepare_works, wp=wp,
        ZkProof=mod("zk.proof").ZkProof, ser=mod("utils.ser"),
        Block=mod("core.blocks").Block, errors=mod("blockchain.error"),
        cfg=mod("config.blockchain"))


PORT, JAX = lib("bazuka_tpu_torch"), lib("bazuka_tpu")
assert set(vars(chip_smoke.PORT)) <= set(vars(PORT))


@pytest.fixture(autouse=True)
def dummy_proofs_restored():
    saved = zkproof._ALLOW_DUMMY, jzkproof._ALLOW_DUMMY
    yield
    zkproof._ALLOW_DUMMY, jzkproof._ALLOW_DUMMY = saved


def small_config(m):
    """The test chain with one batch of each kind per block."""
    conf = m.cfg.get_test_blockchain_config()
    for kind in ("deposit", "withdraw", "update"):
        setattr(conf.mpn_config, f"mpn_num_{kind}_batches", 1)
    return conf


def plain(x):
    """An object of either package as nested tuples of plain values."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(
            plain(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return tuple(plain(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((plain(k), plain(v)) for k, v in x.items()))
    assert isinstance(x, (int, str, bytes, float, type(None))), type(x)
    return x


def flow(m):
    """The two dev-chain blocks on the test chain, with dummy proofs.
    Returns (DevChain, what each block shows)."""
    dc = chip_smoke.DevChain(small_config(m), m)
    prover = dc.worker.get_address()
    out = []
    for block in (1, 2):
        pool = dc.prepare(block)
        assert len(pool.works) == 3
        assert pool.ready(dc.validator, 1) is None
        random.seed(block)
        assigned = sorted(pool.get_works(prover))
        refused = not pool.prove(0, prover, m.ZkProof.dummy(False))
        proven = [pool.prove(w, prover, m.ZkProof.dummy(True))
                  for w in sorted(pool.works)]
        td, blk = dc.draft(pool, block)
        bad = dc.tampered_block(blk, m.ZkProof.dummy(False))
        refused_in_block = dc.refuses(bad)
        dc.chain.apply_block(blk)
        out.append({
            "works": [(w.data_kind, w.public_inputs.as_list(), w.reward,
                       plain(w.new_root), plain(w.transitions))
                      for _, w in sorted(pool.works.items())],
            "delta": plain(pool.final_delta), "assigned": assigned,
            "ready": (m.ser.dumps(td.tx), td.tx.hash()),
            "block": (blk.header.hash(), m.ser.dumps(blk)),
            "checksum": dc.chain.db_checksum(),
            "verdicts": (refused, proven, refused_in_block)})
    return dc, out


def test_two_block_flow_equals_jax():
    dc, port = flow(PORT)
    _, jax = flow(JAX)
    for b, (p, j) in enumerate(zip(port, jax)):
        for key in p:
            assert p[key] == j[key], (b + 1, key)
        assert p["verdicts"] == (True, [True] * 3, True)
    assert [len(w[4]) for w in port[1]["works"]] == [1, 2, 3]
    assert dc.state() == dc.expected()
    assert len(dc.rewards) == 2
    assert chip_smoke.replayed_checksums(
        dc.conf, [PORT.ser.loads(PORT.Block, b["block"][1]) for b in port]
    ) == [b["checksum"] for b in port]


def test_extract_delta_equals_jax():
    cid = "Null"
    ops = []
    for pkg, m in (("bazuka_tpu_torch", PORT), ("bazuka_tpu", JAX)):
        keys = importlib.import_module(f"{pkg}.db.keys")
        state = importlib.import_module(f"{pkg}.zk.state")
        ops.append([
            m.db.Put(keys.local_value(cid, "0_1", True),
                     state.scalar_to_blob(5)),
            m.db.Put("ACB-x-Ziesha", b"\1"),
            m.db.Remove(keys.local_value(cid, "3_4_0", True)),
            m.db.Put(keys.local_value(cid, "2", True),
                     state.scalar_to_blob(2**200 + 1))])
    got = PORT.wp.extract_delta(ops[0])
    assert got == JAX.wp.extract_delta(ops[1])
    assert got == {(0, 1): 5, (3, 4, 0): None, (2,): 2**200 + 1}


def test_bad_dummy_proof_refused():
    conf = small_config(PORT)
    chain = PORT.KvStoreChain(PORT.RamKvStore(), conf)
    v = PORT.TxBuilder(b"VALIDATOR")
    chain._set_balance(v.get_address(), PORT.ContractId.ZIESHA, 1000)
    pool = PORT.prepare_works(
        conf.mpn_config, chain, {}, [], [], [], 100, 10, 10, 10, 0, v, v)
    assert not pool.prove(0, v.get_address(), PORT.ZkProof.dummy(False))
    assert pool.ready(v, 1) is None
    assert pool.prove(0, v.get_address(), PORT.ZkProof.dummy(True))
    assert not pool.prove(0, v.get_address(), PORT.ZkProof.dummy(True))


def test_state_carried_across_from_jax():
    jdc = chip_smoke.DevChain(small_config(JAX), JAX)
    blocks = []
    for block in (1, 2):
        pool = jdc.prepare(block)
        for w in sorted(pool.works):
            assert pool.prove(w, jdc.worker.get_address(),
                              JAX.ZkProof.dummy(True))
        _, blk = jdc.draft(pool, block)
        blocks.append(blk)
        if block == 1:
            jdc.chain.apply_block(blk)
            pairs = jdc.chain.db.pairs("")
    store = PORT.RamKvStore()
    store.update([PORT.db.Put(k, v) for k, v in pairs])
    chain = PORT.KvStoreChain(store, small_config(PORT))
    assert chain.db_checksum() == jdc.chain.db_checksum()
    zsh, jzsh = PORT.ContractId.ZIESHA, JAX.ContractId.ZIESHA
    for seed in [b"D%d" % i for i in range(3)] + [b"DEV-VALIDATOR"]:
        u, ju = PORT.TxBuilder(seed), JAX.TxBuilder(seed)
        assert (chain.get_balance(u.get_address(), zsh)
                == jdc.chain.get_balance(ju.get_address(), jzsh))
        assert (plain(chain.get_mpn_account(u.get_mpn_address()))
                == plain(jdc.chain.get_mpn_account(ju.get_mpn_address())))
    cid = chain.config.mpn_config.mpn_contract_id
    assert cid.scalar == jdc.cid.scalar
    assert (plain(chain.get_contract_account(cid))
            == plain(jdc.chain.get_contract_account(jdc.cid)))
    jdc.chain.apply_block(blocks[1])
    chain.apply_block(PORT.ser.loads(PORT.Block,
                                     JAX.ser.dumps(blocks[1])))
    assert chain.db_checksum() == jdc.chain.db_checksum()
    assert chain.get_height() == 3


@pytest.mark.slow
def test_dev_chain_keys_and_a_proven_block_on_the_cpu():
    from bazuka_tpu_torch.groth16 import prove
    from bazuka_tpu_torch.mpn.circuits import synthesize_circuit

    keys = {}
    conf = PORT.cfg.get_dev_blockchain_config(3, 1, 1, device="cpu",
                                              keys=keys)
    jconf = JAX.cfg.get_dev_blockchain_config(3, 1, 1)
    for kind in ("deposit", "withdraw", "update"):
        assert plain(getattr(conf.mpn_config, f"{kind}_vk")) == plain(
            getattr(jconf.mpn_config, f"{kind}_vk"))
    assert PORT.ser.dumps(conf.genesis) == JAX.ser.dumps(jconf.genesis)
    dc = chip_smoke.DevChain(conf)
    pool = dc.prepare(1)
    prover = dc.worker.get_address()
    for wid, work in sorted(pool.works.items()):
        circuit, _ = chip_smoke.work_circuit(work, prover)
        proof = prove.create_proof(keys[work.data_kind]["params"],
                                   synthesize_circuit(circuit), device="cpu")
        zp = PORT.ZkProof.groth16(proof)
        assert not pool.prove(wid, prover, chip_smoke.negated_a(zp))
        assert pool.prove(wid, prover, zp)
    _, blk = dc.draft(pool, 1)
    dc.chain.apply_block(blk)
    assert dc.chain.get_height() == 2
