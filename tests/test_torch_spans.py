"""The span-and-counter recorder (`bazuka_tpu_torch.utils.spans`) and its
spans inside the prover, keygen and the NTT, on the CPU at toy sizes.

The recorder is process-global, so every test reads only the calls it
made itself: the newest entries of `snapshot()`.
"""

import contextvars
import sys
import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke
from bazuka_tpu_torch import parallel as par
from bazuka_tpu_torch.crypto import bls12_381 as bls
from bazuka_tpu_torch.fields.host import FR_MODULUS
from bazuka_tpu_torch.fields.limbs import fr_field, ints_to_array, to_torch
from bazuka_tpu_torch.groth16 import keygen, prove
from bazuka_tpu_torch.ops import msm_lm
from bazuka_tpu_torch.ops import ntt
from bazuka_tpu_torch.parallel import prove as pprove
from bazuka_tpu_torch.utils import spans

STAGES = ["setup", "witness_encode", "row_eval", "h_ntt", "dedup_plans",
          "msm_a", "msm_b_g1", "msm_h", "msm_l", "msm_b_g2", "combine"]
HOST_STAGES = STAGES[:5] + [
    f"{kind}_{name}" for name in ("a", "b_g1", "h", "l", "b_g2")
    for kind in ("upload", "msm")] + ["combine"]
KEYGEN_STAGES = ["setup", "lagrange_host", "col_eval", "scalar_algebra",
                 "h_scalars_host", "g1_head_ic", "a_query", "b_g1_query",
                 "l_query", "h_query", "g2_head_b_g2_query"]


@pytest.fixture(scope="module")
def toy():
    params = keygen.load_parameters(chip_smoke.TOY_KEY, device="cpu")
    cs, _ = chip_smoke.toy_circuit()
    return params, cs


def newest(name, n=1):
    """The n newest recorded calls of `name`, oldest first."""
    got = [c for c in spans.snapshot() if c["name"] == name]
    assert len(got) >= n
    return got[-n:]


def test_spans_nest_and_sum_within_their_call():
    with spans.call("nest"):
        with spans.span("outer"):
            with spans.span("inner"):
                time.sleep(0.002)
        with spans.span("outer"):
            pass
        with spans.span("other"):
            time.sleep(0.001)
        spans.count("things", 3)
        spans.count("things")
        assert spans.timed("max", max, 3, 4) == 4
        with pytest.raises(ZeroDivisionError):
            spans.timed("max", divmod, 1, 0)
    with spans.span("loose"):  # outside any call: dropped
        spans.count("loose")
    [c] = newest("nest")
    s = c["spans"]
    assert s["inner"] >= 0.002 and s["inner"] <= s["outer"]
    assert s["outer"] + s["other"] <= c["seconds"]
    assert c["seconds"] == (c["end_ns"] - c["start_ns"]) / 1e9
    assert s["max"] <= c["seconds"]
    assert c["counts"] == {"inner": 1, "outer": 2, "other": 1, "things": 4,
                           "max": 2}
    assert all("loose" not in k["spans"] for k in spans.snapshot())


def test_call_inside_a_call_is_a_root_of_its_own():
    with spans.call("outer_root"):
        with spans.call("inner_root"):
            spans.count("x")
        spans.count("y")
    [outer] = newest("outer_root")
    [inner] = newest("inner_root")
    assert inner["counts"] == {"x": 1} and outer["counts"] == {"y": 1}


def test_kept_calls_are_bounded():
    for i in range(spans.MAX_CALLS + 10):
        with spans.call(f"bound{i}"):
            pass
    snap = spans.snapshot()
    assert len(snap) == spans.MAX_CALLS
    assert [c["name"] for c in snap[-3:]] == [
        f"bound{i}" for i in range(spans.MAX_CALLS + 7, spans.MAX_CALLS + 10)]
    assert snap[0]["name"] == "bound10"


def test_concurrent_spans_lose_no_update():
    threads, per = 16, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with spans.call("stress"):
            def work():
                for _ in range(per):
                    with spans.span("s"):
                        pass
                    spans.timed("t", int, 1)
                    spans.count("n")
            ts = [threading.Thread(target=contextvars.copy_context().run,
                                   args=(work,)) for _ in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    [c] = newest("stress")
    assert c["counts"] == {"s": threads * per, "t": threads * per,
                           "n": threads * per}


def test_dedup_build_lands_in_its_own_proof(toy):
    params, cs = toy
    for r in (3, 5):
        prove.create_proof(params, cs, r=r, s=4, device="cpu")
    a, b = newest("create_proof", 2)
    for c in (a, b):
        assert c["counts"]["dedup.build"] == 1
        assert 0 < c["spans"]["dedup.build"] <= c["seconds"]
        assert c["start_ns"] <= c["end_ns"]
        for k in ("witness.assignment", "witness.limbs"):
            assert c["spans"][k] <= c["spans"]["witness_encode"]
        assert sum(c["spans"][k] for k in STAGES) <= c["seconds"]
    assert a["end_ns"] <= b["start_ns"]


def test_profiler_carries_a_range_per_span(toy, monkeypatch):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    params, cs = toy
    record = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        prove.create_proof(params, cs, r=3, s=4, device="cpu",
                           record=record)
    bz = [e for e in prof.profiler.kineto_results.events()
          if e.name().startswith("bz.")]
    names = [e.name() for e in bz]
    # host ranges of operator scope: the profiler copies user-scope ranges
    # onto the device's timeline, where they would read as device work
    assert all(e.device_type() == DeviceType.CPU
               and not e.is_user_annotation() for e in bz)
    [c] = newest("create_proof")
    assert list(record["seconds"]) == STAGES
    for stage in STAGES + ["create_proof", "witness.assignment",
                           "witness.limbs"]:
        assert names.count("bz." + stage) == 1, stage
    # the profiler follows the thread that started it, not the dedup
    # worker: its span is in the call record alone
    assert "bz.dedup.build" not in names and c["counts"]["dedup.build"] == 1
    assert c["counts"]["msm.sync"] >= 5
    assert names.count("bz.msm.sync") == c["counts"]["msm.sync"]

    opened = []
    real = torch._C._profiler._RecordFunctionFast
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda name: opened.append(name) or real(name))
    prove.create_proof(params, cs, r=3, s=4, device="cpu", record={})
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("outside"):  # no call: no range
            pass
        with spans.call("probe"):
            with spans.span("inside"):
                pass
            spans.timed("hot", int, 7)
    assert opened == ["bz.probe", "bz.inside", "bz.hot"]


def test_a_stage_left_open_by_an_exception_closes_before_its_call(
        monkeypatch):
    log = []

    class Range:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            log.append(("enter", self.name))

        def __exit__(self, *exc):
            log.append(("exit", self.name))

    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Range)
    with pytest.raises(ValueError):
        with spans.call("boom"):
            st = spans.Stages("first")
            st.next("second")
            raise ValueError
    assert log == [("enter", "bz.boom"), ("enter", "bz.first"),
                   ("exit", "bz.first"), ("enter", "bz.second"),
                   ("exit", "bz.second"), ("exit", "bz.boom")]
    [c] = newest("boom")
    assert set(c["spans"]) == {"first"}


def toy_evals(d, seed):
    F = fr_field()
    rng = np.random.default_rng(seed)
    return [F.to_mont(to_torch(ints_to_array(
        [int(v) % FR_MODULUS for v in rng.integers(0, 2**62, d)], 16),
        "cpu")) for _ in range(3)]


def test_ntt_table_builds_are_counted(monkeypatch):
    d = 16
    monkeypatch.setattr(ntt, "_TABLE_CACHE_MAX_LOG_N", 3)
    with spans.call("h_uncached"):
        want = prove.compute_h_mont(toy_evals(d, 1), d)
    monkeypatch.undo()
    ntt.clear_table_cache()
    try:
        for name in ("h_first", "h_cached"):
            with spans.call(name):
                got = prove.compute_h_mont(toy_evals(d, 1), d)
            assert torch.equal(got, want)
    finally:
        ntt.clear_table_cache()
    assert newest("h_uncached")[0]["counts"] == {"ntt.table_build": 11}
    # forward and inverse stage twiddles and coset scales: four tables
    assert newest("h_first")[0]["counts"] == {"ntt.table_build": 4}
    assert newest("h_cached")[0]["counts"] == {}


def test_msm_sync_counts_each_host_read_of_the_drain(monkeypatch):
    n, chunk = 64, 16
    rng = np.random.default_rng(7)
    pts = [bls.g1_mul(bls.G1_GEN, int(k)) for k in rng.integers(1, 2**30, n)]
    P, inf = msm_lm.points_to_am(pts, device="cpu")
    scalars = [int(k) for k in rng.integers(1, 2**62, n)]
    reads = []
    real_bool = torch.Tensor.__bool__
    real_v3 = msm_lm._msm_v3

    def spy_bool(t):
        reads.append(1)
        return real_bool(t)

    def v3(*args):
        with monkeypatch.context() as m:
            m.setattr(torch.Tensor, "__bool__", spy_bool)
            return real_v3(*args)

    monkeypatch.setattr(msm_lm, "_msm_v3", v3)
    with spans.call("msm"):
        got = msm_lm.msm_lm(P, inf, msm_lm.enc_scalars(scalars, "cpu"),
                            c=4, nbits=64, chunk=chunk)
    want = None
    for p, s in zip(pts, scalars):
        want = bls.g1_add(want, bls.g1_mul(p, s))
    assert got == want
    [c] = newest("msm")
    assert len(reads) >= n // chunk
    assert c["counts"] == {"msm.sync": len(reads)}
    assert 0 < c["spans"]["msm.sync"] <= c["seconds"]


def test_record_seconds_keeps_its_stages_in_order(toy):
    params, cs = toy
    rec = {}
    host = keygen.generate_parameters(cs, seed=b"t", device="cpu",
                                      record=rec, device_queries=False)
    assert list(rec["seconds"]) == KEYGEN_STAGES
    [c] = newest("generate_parameters")
    assert {k: c["spans"][k] for k in KEYGEN_STAGES} == rec["seconds"]
    # create_proof's order with the queries on the card: in the profiler's
    # test above
    rec = {}
    prove.create_proof(host, cs, r=7, s=11, device="cpu", record=rec)
    assert list(rec["seconds"]) == HOST_STAGES
    [c] = newest("create_proof")
    assert {k: c["spans"][k] for k in HOST_STAGES} == rec["seconds"]
    mesh = par.make_mesh(2, ["cpu"])
    before = spans.snapshot()[-1:]
    for key, want in ((params, STAGES), (host, HOST_STAGES)):
        rec = {}
        pprove.create_proof_sharded(key, cs, mesh, r=7, s=11, record=rec)
        assert list(rec["seconds"]) == want
    # the sharded prover is no root call: its stages time `record` alone
    assert spans.snapshot()[-1:] == before
