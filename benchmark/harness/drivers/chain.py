"""Driver "chain": a validator producing dev-chain blocks back to back.

Set-up makes the chain's three MPN keys on the card from the seed
(`get_dev_blockchain_config` at the configuration's sizes), the chain and
its users (`harness.devchain`), and produces one block of each kind to
warm up.  The window then produces blocks, alternating the two kinds, in whole
pairs until `--seconds` have passed; `block_s` is the window's seconds over its
blocks.  A block is what the node's heartbeat does for it: `prepare_works`,
each work's circuit synthesised and proven on the card under its key (r, s
drawn from the seed), `MpnWorkPool.prove` (one host pairing check each),
then `ready` and `draft_block`, and `apply_block`.  The benchmark's own
spans time each layer.

Every block's three proofs are judged against the plain reference
(`reference.groth16`, the keys' toxic waste from their seeds) and the
chain's balances after each block against the reference's arithmetic
(`reference.chain`), after the window.  A traced run produces one more
block under torch.profiler.
"""

from __future__ import annotations

import gc
import random
import time

import torch

from bazuka_tpu_torch.blockchain.chain import prover_commitment
from bazuka_tpu_torch.config.blockchain import get_dev_blockchain_config
from bazuka_tpu_torch.core.transaction import ContractId
from bazuka_tpu_torch.groth16 import prove
from bazuka_tpu_torch.mpn.circuits import synthesize_circuit
from bazuka_tpu_torch.ops import _cuda
from bazuka_tpu_torch.zk.proof import ZkProof
from reference import chain as ref_chain
from reference import groth16 as ref
from reference.curve import R

from .. import trace as tr
from ..devchain import DevChain
from ..mpn_batch import KINDS
from ..outcome import Outcome, log
from .prove import points, ref_circuit, sync


def key_seed(seed: int) -> bytes:
    """The keys' seed; each circuit's key is seeded with it and the
    circuit's name appended (`get_dev_blockchain_config`)."""
    return b"benchmark-dev-key-%d" % seed


def work_circuit(work, prover):
    """The circuit of an `MpnWork` as the prover `prover` (an address)
    proves it: the commitment of its reward, the work's public inputs,
    its transitions padded with its kind's null transition and, for the
    update, the fee token Ziesha."""
    mc = work.config
    cls, null, batch_key = KINDS[work.data_kind]
    log4_batch = getattr(mc, batch_key)
    inputs = [prover_commitment(prover, work.reward),
              *work.public_inputs.as_list()]
    pad = (1 << (2 * log4_batch)) - len(work.transitions)
    extra = ({"fee_token": ContractId.ZIESHA.scalar}
             if work.data_kind == "update" else {})
    return cls(mc.log4_tree_size, mc.log4_token_tree_size, log4_batch,
               *inputs, transitions=list(work.transitions) + [
                   null.null(mc.log4_tree_size, mc.log4_token_tree_size)
                   for _ in range(pad)], **extra)


class Validator:
    def __init__(self, run):
        cell, self.dev = run.cell, run.device
        t = time.perf_counter()
        if self.dev.type == "cuda":
            _cuda.build_all()
            t = log("build", t)
        m = cell.config["mpn"]
        if len({m[k] for k in (b for _, _, b in KINDS.values())}) != 1:
            raise ValueError("the dev chain has one batch size")
        self.keys = {}
        conf = get_dev_blockchain_config(
            m["log4_tree_size"], m["log4_token_tree_size"],
            m["log4_deposit_batch_size"], seed=key_seed(run.seed),
            device=str(self.dev), keys=self.keys)
        t = log("keys", t)
        self.dc = DevChain(conf, cell.traffic, run.seed)
        log("chain", t)
        self.prover = self.dc.worker.get_address()
        self.rng = random.Random(run.seed)
        self.block_no = 0
        self.proofs = []  # (kind, constraint system, r, s, proof)
        self.states = []  # the chain's state after each block
        self.spans = []  # (layer, start, end) of every block

    def timed(self, layer, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        self.spans.append((layer, t, time.perf_counter()))
        return out

    def block(self):
        self.block_no += 1
        dc, b = self.dc, self.block_no
        pool = self.timed("workpool", dc.prepare, b)
        for wid, work in sorted(pool.works.items()):
            cs = self.timed("synthesis", lambda: synthesize_circuit(
                work_circuit(work, self.prover)))
            r, s = self.rng.randrange(1, R), self.rng.randrange(1, R)
            params = self.keys[work.data_kind]["params"]
            proof = self.timed("prover", self.prove, params, cs, r, s)
            ok = self.timed("workpool", pool.prove, wid, self.prover,
                            ZkProof.groth16(proof))
            if not ok:
                raise RuntimeError(f"block {b}: the pool refused the "
                                   f"{work.data_kind} proof")
            self.proofs.append((work.data_kind, cs, r, s, proof))
        blk = self.timed("chain", dc.draft, pool, b)
        self.timed("chain", dc.chain.apply_block, blk)
        self.states.append(dc.state())

    def prove(self, params, cs, r, s):
        proof = prove.create_proof(params, cs, r, s, device=self.dev)
        sync(self.dev)
        return proof


def per_block(spans, blocks: int) -> dict:
    out = {}
    for layer, a, b in spans:
        out[layer] = out.get(layer, 0.0) + (b - a) / blocks
    return out


def judge(v, seed: int) -> tuple:
    """(the numbers that decide `correct`: wrong proof points and wrong
    balances after each block, the wrong proofs)."""
    waste = {k: ref.toxic(key_seed(seed) + k.encode()) for k in KINDS}
    rows = {}  # L_j(τ) of each kind's circuit, which every block shares
    wrong = bad = 0
    for kind, cs, r, s, proof in v.proofs:
        circuit = ref_circuit(cs)
        if kind not in rows:
            rows[kind] = ref.lagrange_rows(circuit, waste[kind][0])
        q = ref.qap_at(circuit, cs.full_assignment(), rows[kind])
        w = ref.wrong_points(points(proof),
                             ref.expected_proof(q, waste[kind], r, s))
        wrong += w
        bad += w > 0
    t = v.dc.traffic
    want = ref_chain.expected_states(len(v.dc.users), t["l1_funds"],
                                     v.dc.treasury, v.dc.conf.reward_ratio,
                                     v.dc.sent)
    balances = sum(ref_chain.mismatches(s, w)
                   for s, w in zip(v.states, want))
    balances += abs(len(v.states) - len(want))
    return {"wrong_points": (wrong, 0), "wrong_balances": (balances, 0)}, bad


def run(run) -> Outcome:
    v = Validator(run)
    t = time.perf_counter()
    v.block()  # warm-up: one block of each kind
    v.block()
    log("warm blocks", t)
    dev = v.dev
    cuda = dev.type == "cuda"
    v.spans.clear()
    t0 = time.perf_counter()
    n = 0
    while True:  # whole pairs of blocks, one of each kind
        v.block()
        v.block()
        n += 2
        if time.perf_counter() - t0 >= run.seconds:
            break
    window = time.perf_counter() - t0
    t = log(f"window ({n} blocks)", t0)
    layer = {"per_block": per_block(v.spans, n)}
    trace, spans = None, []
    if run.trace and cuda:
        v.spans.clear()
        _, trace = tr.profiled(v.block)
        spans = list(v.spans)
        layer["idle_pct"] = 100.0 * (1 - trace.busy_s() / trace.window_s)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    v.keys.clear()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, bad = judge(v, run.seed)
    log(f"reference ({len(v.proofs)} proofs, {len(v.states)} blocks)", t)
    return Outcome(window_start=t0, end_to_end={"block_s": window / n},
                   attempted=len(v.proofs), failed=bad, checks=checks,
                   memory_peak_bytes=peak, layer=layer, trace=trace,
                   spans=spans)
