"""The plain reference against the program on the CPU, and the faults that
`correct` has to catch: a run of the prover's driver at a tiny circuit
with its timed path broken underneath comes out not correct, and the dev
chain's balances with a step left out or half a batch dropped do too.

The tiny circuit (16 constraints) keeps the CPU's plain kernels to about a
minute for the module; the cells' own sizes run on the card
(`benchmark/control.py`)."""

import json
from pathlib import Path

import pytest
import torch

from bazuka_tpu_torch.crypto import bls12_381 as bls
from bazuka_tpu_torch.groth16 import keygen
from bazuka_tpu_torch.groth16 import prove as program
from bazuka_tpu_torch.groth16.r1cs import ONE, lc
from bazuka_tpu_torch.ops import msm_lm
from harness import main, mpn_batch, spec
from harness.drivers import prove as driver
from harness.outcome import Run
from reference import curve
from reference import groth16 as ref

ROOT = Path(__file__).resolve().parent.parent.parent


class Tiny:
    """x, then x_{i+1} = x_i^2 + i for n steps, the last public."""

    def __init__(self, x: int, n: int = 12):
        self.x, self.n = x, n

    def synthesize(self, cs):
        xi = cs.alloc_input(self.x)
        acc = cs.alloc(self.x)
        cs.enforce(lc((xi, 1)), lc((ONE, 1)), lc((acc, 1)))
        v = self.x
        for i in range(self.n):
            nv = v * v + i
            nxt = cs.alloc(nv)
            cs.enforce(lc((acc, 1)), lc((acc, 1)), lc((nxt, 1), (ONE, -i)))
            acc, v = nxt, nv
        out = cs.alloc_input(v)
        cs.enforce(lc((acc, 1)), lc((ONE, 1)), lc((out, 1)))


def test_curve_matches_the_port():
    for k in (1, 2, 7, ref.R - 1, 2 ** 200 + 12345):
        assert curve.g1_mul(k) == bls.g1_mul(bls.G1_GEN, k)
        assert curve.g2_mul(k) == bls.g2_mul(bls.G2_GEN, k)
        assert curve.g1_on_curve(curve.g1_mul(k))
        assert curve.g2_on_curve(curve.g2_mul(k))
    assert curve.g1_mul(ref.R) is None


def test_toxic_waste_is_the_keys():
    assert ref.toxic(b"seed") == tuple(keygen._rng_scalars(
        b"seed", 5, b"toxic"))


@pytest.fixture(scope="module")
def tiny_run():
    """(cell, a function running the prove driver on the tiny circuit)."""
    cell = spec.Cell(ROOT, "mainnet.withdraw.full")

    def run(monkeypatch, seed=2 ** 31 + 11):
        monkeypatch.setattr(mpn_batch, "build",
                            lambda config, traffic, s: (Tiny(s % 997), None))
        return main.execute(Run(cell, seed, 0.01, False,
                                torch.device("cpu")), 0.0, "cpu")
    return run


def test_program_proofs_equal_the_reference(tiny_run, monkeypatch):
    out = tiny_run(monkeypatch)
    assert out["correct"] is True
    assert out["checks"]["wrong_points"] == {"value": 0, "limit": 0}
    assert out["attempted"] == 2


def test_an_answer_altered_where_it_is_made(tiny_run, monkeypatch):
    orig = program.assemble

    def altered(pk, sums, r, s):
        sums["h"] = bls.g1_add(sums["h"], bls.G1_GEN)
        return orig(pk, sums, r, s)
    monkeypatch.setattr(program, "assemble", altered)
    out = tiny_run(monkeypatch)
    assert out["correct"] is False
    assert out["checks"]["wrong_points"]["value"] == 2


def test_half_the_batch_left_out(tiny_run, monkeypatch):
    orig = msm_lm.msm_lm

    def half(P_am, inf, scalars, **kw):
        s = msm_lm.take_scalars(scalars).clone()
        s[s.shape[0] // 2:] = 0
        return orig(P_am, inf, [s], **kw)
    monkeypatch.setattr(msm_lm, "msm_lm", half)
    out = tiny_run(monkeypatch)
    assert out["correct"] is False


def test_a_proof_returned_unchanged(tiny_run, monkeypatch):
    orig, first = program.create_proof, []

    def stale(*args, **kw):
        first.append(orig(*args, **kw))
        return first[0]
    monkeypatch.setattr(driver.prove, "create_proof", stale)
    out = tiny_run(monkeypatch)
    assert out["correct"] is False
    assert out["failed"] == 1


def test_a_broken_witness_is_caught():
    cs = __import__("bazuka_tpu_torch.mpn.circuits", fromlist=["x"]) \
        .synthesize_circuit(Tiny(5))
    params = keygen.generate_parameters(cs, seed=b"ctl", device="cpu")
    circuit = driver.ref_circuit(cs)
    waste = ref.toxic(b"ctl")
    q = ref.qap_at(circuit, cs.full_assignment(),
                   ref.lagrange_rows(circuit, waste[0]))
    good = program.create_proof(params, cs, 3, 5, device="cpu")
    assert ref.wrong_points(driver.points(good),
                            ref.expected_proof(q, waste, 3, 5)) == 0
    from control import Broken, broken_index

    bad = program.create_proof(params, Broken(cs, broken_index(cs)), 3, 5,
                               device="cpu")
    assert ref.wrong_points(driver.points(bad),
                            ref.expected_proof(q, waste, 3, 5)) >= 1


def dev_chain_states(drop_half=False, skip_apply=None):
    """Four blocks of the dev chain with dummy proofs (the test config at
    batches of 4): (states, DevChain)."""
    from bazuka_tpu_torch.config.blockchain import get_test_blockchain_config
    from bazuka_tpu_torch.zk import proof as zk
    from harness import devchain

    tr = json.loads((ROOT / "benchmark" / "traffic" / "block.json")
                    .read_text())
    try:
        conf = get_test_blockchain_config()
        for k in ("deposit", "withdraw", "update"):
            setattr(conf.mpn_config, f"mpn_num_{k}_batches", 1)
        dc = devchain.DevChain(conf, tr, 2 ** 31 + 21)
        states = []
        for b in range(1, 5):
            deps, wds, pays = dc.mpn_txs(b)
            if drop_half:
                deps, pays = deps[:len(deps) // 2], pays[:len(pays) // 2]
            v = dc.validator.get_address()
            reward = dc.chain.min_validator_reward(v)
            pool = devchain.prepare_works(
                conf.mpn_config, dc.chain,
                {"w": devchain.MpnWorker(dc.worker.get_address())},
                deps, wds, pays, reward,
                *(reward // 100 * p for p in devchain.WORK_PERCENT.values()),
                dc.chain.get_deposit_nonce(v, dc.cid), dc.validator,
                dc.validator)
            for wid in sorted(pool.works):
                assert pool.prove(wid, dc.worker.get_address(),
                                  zk.ZkProof.dummy(True))
            blk = dc.draft(pool, b)
            if b != skip_apply:
                dc.chain.apply_block(blk)
            states.append(dc.state())
    finally:
        zk.allow_dummy_proofs(False)
    return states, dc


@pytest.mark.parametrize("fault", [None, "skip_apply", "drop_half"])
def test_dev_chain_balances(fault):
    from reference import chain as ref_chain

    states, dc = dev_chain_states(drop_half=fault == "drop_half",
                                  skip_apply=4 if fault == "skip_apply"
                                  else None)
    want = ref_chain.expected_states(
        len(dc.users), dc.traffic["l1_funds"], dc.treasury,
        dc.conf.reward_ratio, dc.sent)
    wrong = sum(ref_chain.mismatches(s, w) for s, w in zip(states, want))
    assert (wrong == 0) == (fault is None)
