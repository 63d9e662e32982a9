"""The per-layer metrics that read the program's own call records
(`harness/calls.py`), on synthetic snapshots of
`bazuka_tpu_torch.utils.spans`."""

import sys

import pytest

from harness import spec

PER_PROOF = ("prover.witness_host_s", "prover.dedup_build_s",
             "msm.host_sync_wait_s", "msm.host_syncs", "ntt.table_builds")
SETUP = ("setup.synthesis_s", "setup.keygen_s", "setup.keygen_host_s")


def proof(scale, slow=1.0):
    """A create_proof record whose spans scale with `scale`; `slow`
    multiplies the first-use costs of a warm proof."""
    return {"name": "create_proof", "start_ns": 0, "end_ns": 1,
            "seconds": 6.0 * scale * slow,
            "spans": {"witness_encode": 2.0 * scale,
                      "witness.assignment": 0.5 * scale * slow,
                      "witness.limbs": 1.0 * scale,
                      "dedup.build": 0.75 * scale,
                      "msm.sync": 0.5 * scale},
            "counts": {"msm.sync": int(60 * scale),
                       "ntt.table_build": int(11 * slow)}}


SNAPSHOT = [
    {"name": "synthesize_circuit", "start_ns": 0, "end_ns": 1,
     "seconds": 30.0, "spans": {}, "counts": {}},
    {"name": "generate_parameters", "start_ns": 0, "end_ns": 1,
     "seconds": 40.0, "spans": {"setup": 1.0, "lagrange_host": 4.0,
                                "h_scalars_host": 6.0, "a_query": 9.0},
     "counts": {"lagrange_host": 1}},
    {"name": "synthesize_circuit", "start_ns": 0, "end_ns": 1,
     "seconds": 2.0, "spans": {}, "counts": {}},
    proof(1.0, slow=20.0),  # the warm proof
    proof(1.0), proof(2.0), proof(1.0), proof(3.0),
]

# medians of five proofs, the warm one the slowest (a mean would give the
# witness 4.3 s and 55 table builds)
WANT = {"prover.witness_host_s": 3.0, "prover.dedup_build_s": 0.75,
        "msm.host_sync_wait_s": 0.5, "msm.host_syncs": 60,
        "ntt.table_builds": 11, "setup.synthesis_s": 32.0,
        "setup.keygen_s": 40.0, "setup.keygen_host_s": 10.0}


@pytest.fixture
def snapshot(monkeypatch):
    from bazuka_tpu_torch.utils import spans

    def use(calls):
        monkeypatch.setattr(spans, "snapshot", lambda: calls)
    return use


def test_readers_take_the_median_proof_and_the_set_up_sum(snapshot):
    snapshot(SNAPSHOT)
    for name in PER_PROOF + SETUP:
        assert spec.reader(name)({}) == pytest.approx(WANT[name]), name


def test_readers_read_zero_without_calls_and_none_without_recorder(
        snapshot, monkeypatch):
    snapshot([])
    for name in PER_PROOF + SETUP:
        assert spec.reader(name)({"stages": [{"witness_encode": 1.0}]}) \
            == 0, name
    # a proof but no set-up call: nothing of set-up ran
    snapshot(SNAPSHOT[3:])
    assert all(spec.reader(n)({}) == 0 for n in SETUP)
    assert all(spec.reader(n)({}) == pytest.approx(WANT[n])
               for n in PER_PROOF)
    # a program from before the recorder: nothing, and no error
    import bazuka_tpu_torch.utils

    monkeypatch.delattr(bazuka_tpu_torch.utils, "spans")
    monkeypatch.setitem(sys.modules, "bazuka_tpu_torch.utils.spans", None)
    assert all(spec.reader(n)({}) is None for n in PER_PROOF + SETUP)


def test_readers_read_a_real_call(snapshot):
    """The readers' keys are the program's own span and counter names."""
    from bazuka_tpu_torch.utils import spans

    with spans.call("create_proof"):
        st = spans.Stages("witness_encode")
        for name in ("witness.assignment", "witness.limbs", "msm.sync"):
            with spans.span(name):
                pass
        spans.count("ntt.table_build", 11)
        st.end()
    [call] = [c for c in spans.snapshot() if c["name"] == "create_proof"][-1:]
    snapshot([call])
    assert spec.reader("msm.host_syncs")({}) == 1
    assert spec.reader("ntt.table_builds")({}) == 11
    assert 0 < spec.reader("prover.witness_host_s")({}) <= call["seconds"]
    assert spec.reader("prover.dedup_build_s")({}) == 0
