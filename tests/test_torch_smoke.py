"""The port stands alone, and `chip_smoke.py`'s real-size proof phase holds
at a tiny size on the CPU.

- Importing every `bazuka_tpu_torch` module (the MPN circuits, witness
  generators and wallet, the chain, its configs, the work pool and the
  VK codec among them), `chip_smoke` and `kernel_ab` adds no
  `jax`, no `bazuka_tpu` and no `cryptography` or `nacl` module to
  `sys.modules`, nor does an Ed25519 signature and its check (compared
  before and after, since a host may pre-import jax).
- `chip_smoke.py` exits non-zero and prints no result without a CUDA
  device, and alone in a directory without the package.
- The real-size proof phase at d = 2^6: the synthetic circuit and known-log
  key prove to the host-computed (A, B, C), the h identity holds, and a
  tampered h fails it.
- The h identity sums a(ρ), b(ρ), c(ρ) from the circuit's terms, so a row
  evaluation fault that keeps a∘b = c still fails it.
- The keygen phase's spot check at d = 2^4: a key generated on the CPU
  passes it, and fails it once one sampled query point is replaced by its
  double.
- The kernel replay's stress lanes reach every plane of a projective Q,
  and the profiles' kernel names map each device kernel to its own row
  only (K3's name is not read as K2's, nor K6's as K3's); a profile's
  device time is summed by row and its busy time is the union of its
  events.
- The presum over a host query's heavy rows gathered alone (the sharded
  prover's `_presum_from_host`) equals the presum over the whole query
  on the device, projective limb for limb and affine.
- The `poseidon` and `eddsa` phases' checks at a tiny size on the plain
  path (a 4^2-leaf tree, 4 signatures): they pass, and fail once one limb
  of a tree level is wrong, a verdict is flipped or a multiply's scalar
  is another.
- The `devchain` phase's flow and checks on the test chain at log4
  (3, 1, 1) with dummy proofs: they pass, and fail once a block is
  missing or altered, a VK is another or a proof's A is negated.
- The replay's inversion rows hold each size's kernel output to its own
  slice of one plain call over every size's operands, and fail when it
  differs.
"""

import json
import os
import pkgutil
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import bazuka_tpu_torch
import chip_smoke
from bazuka_tpu_torch.crypto import bls12_381 as bls
from bazuka_tpu_torch.crypto import jubjub as tjj
from bazuka_tpu_torch.fields.limbs import fp_field, fr_field
from bazuka_tpu_torch.groth16 import keygen, qap
from bazuka_tpu_torch.groth16.prove import _pad_rows, compute_h_mont, create_proof
from bazuka_tpu_torch.groth16.sparse import DeviceR1CS, encode_mont
from bazuka_tpu_torch.fields.limbs import narrow_limbs, to_numpy
from bazuka_tpu_torch.ops import jubjub_batch as jb
from bazuka_tpu_torch.ops import msm_lm
from bazuka_tpu_torch.parallel import prove as pprove

# The shapes here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    mods = sorted(m.name for m in pkgutil.walk_packages(
        bazuka_tpu_torch.__path__, "bazuka_tpu_torch."))
    assert "bazuka_tpu_torch.ops.msm_lm" in mods
    assert {"bazuka_tpu_torch.mpn.circuits", "bazuka_tpu_torch.crypto.ed25519",
            "bazuka_tpu_torch.wallet.tx_builder",
            "bazuka_tpu_torch.ops.poseidon",
            "bazuka_tpu_torch.ops.jubjub_batch",
            "bazuka_tpu_torch.parallel",
            "bazuka_tpu_torch.parallel.prove",
            "bazuka_tpu_torch.blockchain", "bazuka_tpu_torch.config",
            "bazuka_tpu_torch.mpn.workpool",
            "bazuka_tpu_torch.zk.wire"} <= set(mods)
    code = (
        "import importlib, json, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {mods!r} + ['chip_smoke', 'kernel_ab', 'ntt_ab']:\n"
        "    importlib.import_module(m)\n"
        # signing and verifying import nothing later either
        "from bazuka_tpu_torch.core.transaction import ContractId, Money\n"
        "from bazuka_tpu_torch.wallet.tx_builder import TxBuilder\n"
        "b, t = TxBuilder(b'x'), ContractId(5)\n"
        "d = b.deposit_mpn('', t, b.get_mpn_address(), 1, Money(t, 1),\n"
        "                  Money.ziesha(0))\n"
        "assert d.payment.verify_signature()\n"
        "added = sorted(set(sys.modules) - before)\n"
        "print(json.dumps(added))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    added = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in added
           if m.split(".")[0] in ("jax", "jaxlib", "bazuka_tpu",
                                  "cryptography", "nacl")]
    assert not bad, bad
    assert "bazuka_tpu_torch.groth16.prove" in added
    assert "bazuka_tpu_torch.mpn.circuits" in added
    assert "bazuka_tpu_torch.ops.jubjub_batch" in added
    assert "bazuka_tpu_torch.parallel" in added
    assert "bazuka_tpu_torch.parallel.prove" in added
    for m in ("blockchain", "blockchain.chain", "config",
              "config.blockchain", "mpn.workpool", "zk.wire"):
        assert f"bazuka_tpu_torch.{m}" in added


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_presum_over_host_gathered_rows_equals_device_query():
    n = 64
    pts = [bls.g1_mul(bls.G1_GEN, k + 1) for k in range(n)]
    pts[9] = None  # an infinity row inside a heavy group
    am, inf = msm_lm.points_to_am(pts, device="cpu")
    scalars = [3 if i % 4 else 5 for i in range(n)]
    plan = msm_lm.make_dedup_plan(
        to_numpy(msm_lm.enc_scalars(scalars, "cpu")), threshold=8)
    assert plan.active and plan.n_heavy_vals == 2
    narrow = (narrow_limbs(am), inf.to(torch.uint8))
    whole = msm_lm._presum(*narrow, plan, "g1", plan.hpos)
    rows = plan.hpos
    gathered = msm_lm._presum(narrow[0][rows], narrow[1][rows], plan, "g1",
                              np.arange(plan.n_heavy_elems))
    assert torch.equal(gathered, whole)
    host = keygen._narrow(narrow)
    got = pprove._presum_from_host(host, plan, "g1", "cpu")
    want = msm_lm.presum_g1(*narrow, plan)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_chip_smoke_fails_without_cuda_or_package(tmp_path):
    res = _run_smoke(ROOT)
    assert res.returncode == 2
    assert '"ok"' not in res.stdout
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    alone = _run_smoke(tmp_path)
    assert alone.returncode != 0
    assert '"ok"' not in alone.stdout


def test_real_size_phase_at_tiny_size():
    cs, params, sc, d = chip_smoke.real_size_setup(6, "cpu")
    assert d == 64 and cs.compiled().num_vars == cs.n_constraints + 2
    record = {}
    proof = create_proof(params, cs, r=3, s=4, device="cpu", record=record)
    assert record["n_heavy_vals"] >= 1
    checks = chip_smoke.check_real_proof(cs, params, sc, d, proof, record,
                                         3, 4, 123456789)
    assert all(checks.values()), checks
    h = record["h_std"].clone()
    h[0, 0] ^= 1
    assert not chip_smoke.h_identity_holds(cs.compiled(), cs.z, h, d,
                                           987654321)
    wrong = chip_smoke.expected_proof(cs.z, [1] * (d - 1), 2, sc, 3, 4)
    assert proof.c != chip_smoke.keygen.g1_wire(wrong[2])
    assert isinstance(record["seconds"]["msm_b_g2"], float)


def test_h_identity_catches_row_eval_fault():
    cs = chip_smoke.SyntheticCircuit(49, chip_smoke.ROOT_SEED)
    comp, d, rho = cs.compiled(), 64, 555555555
    dr = DeviceR1CS(comp, "cpu")
    z_mont = encode_mont(cs.z, "cpu")
    evs = [_pad_rows(p.eval(z_mont, dr.pal_mont), d) for p in dr.row_plans]
    h = compute_h_mont([e.clone() for e in evs], d)
    assert chip_smoke.h_identity_holds(comp, cs.z, h, d, rho)
    # a chain row: zero its a and c evaluations, so a∘b = c still holds
    j = 30
    assert not (evs[0][j] == 0).all() and not (evs[2][j] == 0).all()
    evs[0][j] = 0
    evs[2][j] = 0
    F = fr_field()
    assert torch.equal(F.mont_mul(evs[0], evs[1]), evs[2])
    assert not chip_smoke.h_identity_holds(comp, cs.z,
                                           compute_h_mont(evs, d), d, rho)


def test_keygen_spot_check_at_tiny_size():
    cs = chip_smoke.SyntheticCircuit(13, chip_smoke.ROOT_SEED)
    comp = cs.compiled()
    d = qap.domain_size(comp.n_constraints, comp.num_inputs)
    assert d == 16
    params = keygen.generate_parameters(cs, seed=b"tiny", device="cpu")
    checks, n_rows = chip_smoke.key_spot_check(comp, params, b"tiny", d)
    assert all(checks.values()), checks
    assert n_rows == 4 * 16 + 14  # the l query has 13 valid rows + a pad
    # a wrong seed's scalars disagree with every query
    wrong, _ = chip_smoke.key_spot_check(comp, params, b"other", d)
    assert not any(wrong.values())
    # row 0 of the a query (always sampled; u_0 is the ONE column's sum)
    # replaced by its double
    am, inf = params.pk.a_query
    assert not inf[0]
    F = fp_field()
    pt = (int(F.decode(am[0, 0])), int(F.decode(am[0, 1])))
    am[0] = F.encode(np.array(bls.g1_double(pt), dtype=object), device="cpu")
    tampered, _ = chip_smoke.key_spot_check(comp, params, b"tiny", d)
    assert not tampered["a_query"]
    assert all(v for k, v in tampered.items() if k != "a_query")


def test_stress_lanes_cover_projective_q():
    F = fp_field()
    gen = torch.Generator()
    gen.manual_seed(5)
    acc = torch.randint(0, 1 << 12, (6, 24, 16), generator=gen,
                        dtype=torch.int32)
    q = torch.randint(0, 1 << 12, (6, 24, 16), generator=gen,
                      dtype=torch.int32)
    mask = torch.zeros(16, dtype=torch.bool)
    s_acc, s_q, s_mask = chip_smoke.stress_lanes(acc, q, mask)
    pm1 = torch.tensor([(F.p - 1 >> (16 * k)) & 0xFFFF for k in range(24)],
                       dtype=torch.int32)
    for x in (s_acc, s_q):
        for lane in (5, 13):
            assert all(torch.equal(x[pl, :, lane], pm1) for pl in range(6))
        for lane in (6, 14):
            for pl in range(6):  # Z2 (planes 4, 5) included
                assert torch.equal(x[pl, :, lane],
                                   pm1 if pl % 2 == 0 else 0 * pm1)
    assert s_mask.nonzero().flatten().tolist() == [5, 6, 13, 14]
    keep = [i for i in range(16) if i % 8 not in (5, 6)]
    assert torch.equal(s_q[:, :, keep], q[:, :, keep])
    assert not mask.any()  # the inputs are not changed


def test_profiled_kernel_names_map_to_their_own_rows():
    rows = {}
    for key, row in chip_smoke.PROFILED_KERNELS:
        name = (f"void (anonymous namespace)::{key}, (anonymous namespace)::"
                "RegSlots<bz::lazy::G1Lazy>, 12>(int const*, long long)")
        rows[row] = chip_smoke.profiled_row(name)
    assert rows == {row: row for _, row in chip_smoke.PROFILED_KERNELS}
    assert len(rows) == 9
    assert chip_smoke.profiled_row("void at::native::sort_kernel") == "other"


def test_device_tally_sums_rows_and_busy_union():
    # overlapping events count once in the busy time, each in its row
    events = [("void bz::mont_mul_kernel<16>", 0.0, 5.0),
              ("void at::native::cat", 3.0, 4.0),
              ("void at::native::cat", 20.0, 1.0),
              ("void at::native::fill", 21.0, 2.0)]
    got = chip_smoke._device_tally(events, wall_s=1e-4, wall_us=50.0)
    assert got["device_events"] == 4
    assert got["device_s"] == {"mont_mul": 5e-6, "other": 7e-6}
    assert list(got["other_by_name_s"]) == ["void at::native::cat",
                                            "void at::native::fill"]
    assert got["device_busy_s"] == 10e-6
    assert got["idle_share"] == 1 - 10 / 100
    assert got["idle_share_profiled"] == 1 - 10 / 50
    assert chip_smoke._device_tally([], 1.0, 1.0) == {}


def test_launch_weighted_reads_each_launch_size_s_row():
    rows = [{"size": [8, 2], "launches": 3, "ms": 1.0, "plain_ms": 2.0,
             "bound_ms": 0.5, "bound_by": "bytes", "max_abs_err": 0.0},
            {"size": [8, 8], "launches": 1, "ms": 3.0, "plain_ms": 2.0,
             "bound_ms": 1.0, "bound_by": "bytes", "max_abs_err": 0.0}]
    summary = chip_smoke.summarize(rows)
    got = chip_smoke.launch_weighted(summary, {(8, 2): 2, (8, 8): 1})
    assert got == {"launches": 3, "ms": 5 / 3, "bound_ms": 2 / 3,
                   "excess_ms": 3.0}
    assert chip_smoke.launch_weighted(summary, {}) == {"launches": 0}
    # one-element sizes (NTT, inversion, curve adds) match on n alone
    ntt = chip_smoke.summarize([{**rows[0], "size": [16]}])
    assert chip_smoke.launch_weighted(ntt, {(16, 0): 4})["excess_ms"] == 2.0


def test_poseidon_and_eddsa_checks_at_tiny_size():
    F = fr_field()
    gen = torch.Generator()
    gen.manual_seed(3)
    rng = np.random.default_rng(3)
    levels = chip_smoke.merkle_levels(
        chip_smoke.random_field_limbs(F, 16, gen, "cpu"))
    assert [lv.shape[0] for lv in levels] == [16, 4, 1]
    checks, n_plain = chip_smoke.tree_checks(levels, rng)
    assert all(checks.values()), checks
    assert n_plain == 5
    bad = [lv.clone() for lv in levels]
    bad[1][2, 7] ^= 1  # one wrong limb in level 1
    checks, _ = chip_smoke.tree_checks(bad, rng)
    assert not checks["tree_plain_equal"]
    assert not checks["tree_host_sampled"]

    batch = chip_smoke.eddsa_batch(4)
    assert batch["tamper"] == ["msg_plus_1", None, None, None]
    verdicts = jb.batch_eddsa_verify(batch["pks"], batch["msgs"],
                                     batch["sigs"], device="cpu")
    assert list(verdicts) == [False, True, True, True]
    assert all(chip_smoke.eddsa_checks(batch, verdicts, rng).values())
    flipped = verdicts.copy()
    flipped[2] = False
    assert not any(chip_smoke.eddsa_checks(batch, flipped, rng).values())

    scalars = chip_smoke.mul_scalars(4, rng)
    assert scalars == [0, 1, tjj.ORDER - 1, tjj.ORDER]
    s_std = F.encode(np.array(scalars, dtype=object), mont=False,
                     device="cpu")
    pks = batch["pks"]
    pts = jb.to_extended(F, *(F.encode(np.array([p[c] for p in pks],
                                                dtype=object), device="cpu")
                              for c in (0, 1)))
    sb = jb.batch_base_mul(F, s_std)
    sp = jb.batch_scalar_mul(F, pts, s_std)
    rows = [0, 1, 2, 3]
    assert all(chip_smoke.mul_checks(scalars, pks, sb, sp, rows).values())
    other = [1, 0] + scalars[2:]
    assert not any(chip_smoke.mul_checks(other, pks, sb, sp, rows).values())


def test_mpn_worker_sends_its_circuit_when_asked():
    """`chip_smoke.mpn_worker` at 4 transfers in a spawn worker: the
    circuit stays there until `host()` asks for it, arrives with the
    pinned-shape result keys, and `check()` finds it satisfied."""
    import multiprocessing

    with multiprocessing.get_context("spawn").Pool(1) as pool:
        host, check = chip_smoke.mpn_worker(pool, 1)
        w = host()
        assert w["transfers"] == w["enabled"] == 4
        assert w["worker_wait_s"] >= 0 and w["transfer_s"] >= 0
        _, inputs, _ = chip_smoke.mpn_update_batch(log4_batch=1)
        assert w["inputs"] == inputs and len(w["txs"]) == 4
        assert w["cs"].n_constraints > 0
        assert check()["satisfied"]


def test_devchain_checks_at_tiny_size():
    """The `devchain` phase's flow and checks (`chip_smoke.DevChain`,
    `replayed_checksums`, `wire_copy`, `negated_a`) on the test chain at
    log4 (3, 1, 1) with dummy proofs: they pass, and fail once a block is
    missing or altered, a VK is another, or a proof's A is negated."""
    from bazuka_tpu_torch.config import blockchain as cfg
    from bazuka_tpu_torch.core.transaction import ContractId
    from bazuka_tpu_torch.groth16.verify import groth16_verify
    from bazuka_tpu_torch.utils import ser
    from bazuka_tpu_torch.zk import proof as zkproof
    from bazuka_tpu_torch.zk.proof import Groth16Proof, ZkProof

    saved = zkproof._ALLOW_DUMMY
    try:
        conf = cfg.get_test_blockchain_config()
        for kind in ("deposit", "withdraw", "update"):
            setattr(conf.mpn_config, f"mpn_num_{kind}_batches", 1)
        dc = chip_smoke.DevChain(conf)
        prover = dc.worker.get_address()
        blocks, sums = [], []
        for block in (1, 2):
            pool = dc.prepare(block)
            for wid in sorted(pool.works):
                assert not pool.prove(wid, prover, chip_smoke.negated_a(
                    ZkProof.dummy(True)))
                assert pool.prove(wid, prover, ZkProof.dummy(True))
            _, blk = dc.draft(pool, block)
            assert dc.refuses(dc.tampered_block(blk, ZkProof.dummy(False)))
            assert not dc.refuses(blk)
            dc.chain.apply_block(blk)
            blocks.append(blk)
            sums.append(dc.chain.db_checksum())
            if block == 1:
                assert dc.state() != dc.expected()
        assert dc.state() == dc.expected()
        assert chip_smoke.replayed_checksums(conf, blocks) == sums
        assert chip_smoke.replayed_checksums(conf, blocks[:1]) == sums[:1]
        other = ser.loads(type(blocks[1]), ser.dumps(blocks[1]))
        other.header.proof_of_stake.timestamp += conf.slot_duration
        assert chip_smoke.replayed_checksums(conf, [blocks[0], other]) != sums

        vks = cfg.load_mainnet_vks()
        tx = cfg.get_mpn_contract_tx(3, 1, 1, 1, vks["deposit"],
                                     vks["withdraw"], vks["update"])
        conf.genesis.body[1] = tx
        conf.mpn_config.mpn_contract_id = ContractId.from_tx(tx)
        for kind in ("deposit", "withdraw", "update"):
            setattr(conf.mpn_config, f"{kind}_vk", vks[kind])
        copied, same_id = chip_smoke.wire_copy(conf)
        assert same_id and copied.mpn_config.update_vk == vks["update"]
        conf.mpn_config.deposit_vk = vks["withdraw"]
        assert not chip_smoke.wire_copy(conf)[1]
    finally:
        zkproof.allow_dummy_proofs(saved)

    params = keygen.load_parameters(chip_smoke.TOY_KEY, device="cpu")
    _, z = chip_smoke.toy_circuit()
    proof = ser.loads(Groth16Proof, bytes.fromhex(chip_smoke.TOY_PROOF_HEX))
    assert groth16_verify(params.vk, [z], proof)
    moved = chip_smoke.negated_a(ZkProof.groth16(proof))
    assert moved.proof.b == proof.b and moved.proof.a.x == proof.a.x
    assert not groth16_verify(params.vk, [z], moved.proof)


def test_inversion_replay_checks_each_size_against_one_plain_call(
        monkeypatch):
    """The replay's inversion rows: one plain call over every size's
    operands, each size's kernel output held to its own slice of it."""
    from bazuka_tpu_torch.ops import field_kernel as fk

    class Event:
        def __init__(self, **_):
            self.t = 0.0

        def record(self):
            self.t = time.perf_counter()

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return (other.t - self.t) * 1e3

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    calls, memo = [], {}
    plain = fk.mont_inv_plain

    def kernel(shift):
        # the plain inversion of a + shift, once per operand (the replay
        # calls the kernel several times to time it)
        def run(F, a):
            key = (shift, a.numpy().tobytes())
            if key not in memo:
                memo[key] = plain(F, a + shift)
            return memo[key]
        return run

    monkeypatch.setattr(fk, "mont_inv_plain",
                        lambda F, a: calls.append(a.shape[0]) or plain(F, a))
    monkeypatch.setattr(fk, "mont_inv", kernel(0))
    gen = torch.Generator()
    gen.manual_seed(5)
    sizes = {(1, 0): 4, (6, 0): 1}
    rows = chip_smoke.inversion_rows(sizes, gen, "cpu")
    assert calls == [7]
    assert [r["size"] for r in rows] == [[1], [6]]
    assert all(r["max_abs_err"] == 0 and r["plain_rows"] == 7
               and r["plain_ms"] == rows[0]["plain_ms"] for r in rows)
    monkeypatch.setattr(fk, "mont_inv", kernel(1))
    with pytest.raises(SystemExit):
        chip_smoke.inversion_rows(sizes, gen, "cpu")
