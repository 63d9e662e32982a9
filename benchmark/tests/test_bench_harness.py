"""The harness on the CPU: traffic by seed, the configuration files, the
copied counting, the result's keys, the module check, and files dropped in
for a new cell found by name with no existing file edited."""

import hashlib
import json
import shutil
from pathlib import Path

import pytest

from harness import counting, main, mpn_batch, spec
from harness.devchain import DevChain
from harness.outcome import Outcome, Run

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def small(config: str = "mainnet") -> dict:
    """A configuration of `benchmark/configs/` at a tree of 4^2 and
    batches of 4, for the CPU."""
    conf = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    for k in conf["mpn"]:
        conf["mpn"][k] = {"log4_tree_size": 2, "log4_token_tree_size": 1
                          }.get(k, 1)
    return conf


@pytest.mark.parametrize("traffic,circuit", [
    ("withdraw.full", "withdraw"), ("withdraw.sparse", "withdraw"),
    ("withdraw.sparse", "deposit"), ("withdraw.sparse", "update")])
def test_batch_is_deterministic_by_seed(traffic, circuit):
    from bazuka_tpu_torch.mpn.circuits import synthesize_circuit

    tr = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    tr["circuit"] = circuit
    tr["accounts"], tr["enabled"] = 4, min(tr["enabled"], 3)
    seed = 2 ** 31 + 17
    circ, a = mpn_batch.build(small(), tr, seed)
    b = mpn_batch.build(small(), tr, seed)[1]
    c = mpn_batch.build(small(), tr, seed + 1)[1]
    assert a == b
    assert a != c
    assert synthesize_circuit(circ).is_satisfied() is None


def test_dev_chain_traffic_is_deterministic_by_seed():
    from bazuka_tpu_torch.config.blockchain import get_test_blockchain_config
    from bazuka_tpu_torch.zk import proof as zk

    tr = json.loads((BENCH / "traffic" / "block.json").read_text())
    try:
        conf = get_test_blockchain_config()
        runs = []
        for seed in (2 ** 31 + 3, 2 ** 31 + 3, 2 ** 31 + 4):
            dc = DevChain(conf, tr, seed)
            dc.mpn_txs(1)
            dc.mpn_txs(2)
            runs.append((dc.sent, [str(u.get_address()) for u in dc.users]))
    finally:
        zk.allow_dummy_proofs(False)
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files_name_their_source_and_cuts(entry):
    conf = json.loads((ROOT / entry["file"]).read_text())
    assert conf["name"] == entry["name"]
    assert conf["source"] == entry["source"]
    assert conf["reduced"] == entry["reduced"]
    assert conf["assumed"] and conf["source_lines"]
    assert entry["file"].startswith(SPEC["paths"][0] + "/")


def test_counting_matches_chip_smoke():
    import chip_smoke as cs

    assert counting.INV_FP_IMADS == cs.INV_FP_IMADS
    assert (counting.HBM_BYTES_PER_S, counting.IMAD_PER_S) == (
        cs.HBM_BYTES_PER_S, cs.IMAD_PER_S)
    for limbs in (16, 24):
        assert counting.mont_mul_imads(limbs) == cs.mont_mul_imads(limbs)
        assert counting.mont_sqr_imads(limbs) == cs.mont_sqr_imads(limbs)
    for n, m in ((1 << 22, 0), (1 << 23, 1 << 11), (1 << 10, 0)):
        assert counting.ntt_imads(n, m) == cs.ntt_imads(n, m)
        row = m or n
        assert counting.ntt_stages(n, m) == pytest.approx(cs.bound(
            (2 * n + row - 1) * 64, cs.ntt_imads(n, m))[0] / 1e3)
    for limbs, n, b in ((16, 1 << 22, 1), (24, 65536, 65536)):
        assert counting.k1_mul(limbs, n, b) == pytest.approx(cs.bound(
            (2 * n + b) * limbs * 4, n * cs.mont_mul_imads(limbs))[0] / 1e3)
    assert counting.inversion(4096) == pytest.approx(cs.bound(
        2 * 4096 * 24 * 4, 4096 * cs.INV_FP_IMADS)[0] / 1e3)
    for (name, (acc_planes, q_planes, n_mul)), (kern, _, _, k_mul) in zip(
            counting.CURVE.items(),
            [k for g in cs.CURVE_KERNELS.values() for k in g]):
        assert name == kern.name and n_mul == k_mul
        L, active = 90112, 70000
        nbytes = (L * (2 * acc_planes * 24 * 4 + 1)
                  + active * q_planes * 24 * 4)
        assert counting.curve_add(name, L, active) == pytest.approx(cs.bound(
            nbytes, active * n_mul * cs.mont_mul_imads(24))[0] / 1e3)


class FakeTrace:
    window_s = 2.0

    def busy_s(self):
        return 1.0

    def device_ops(self):
        return [["k", 1.0]]

    def idle_gaps(self, spans):
        return [["h_ntt", 0.5]]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_exactly_its_keys(trace):
    import torch

    cell = spec.Cell(ROOT, "mainnet.withdraw.full")
    layer = {"stages": [{"witness_encode": 1.0, "row_eval": 0.5,
                         "h_ntt": 1.0, "dedup_plans": 0.1, "msm_a": 1.0,
                         "msm_b_g2": 2.0}],
             "roofline_pct": 30.0, "idle_pct": 50.0,
             "window_peak_bytes": 2 ** 33}
    out = Outcome(window_start=10.0, end_to_end={"proof_s": 4.0},
                  attempted=3, failed=0, checks={"wrong_points": (0, 0)},
                  memory_peak_bytes=5, layer=layer, trace=FakeTrace())
    res = main.result(Run(cell, 1, 1.0, trace, torch.device("cpu")), out,
                      1.0, "cpu")
    want = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res) == want + (["breakdown"] if trace else []) + ["checks"]
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"} | (
        {"busy_s", "window_s"} if trace else set())
    names = {m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)}
    assert set(res["metrics"]) == names
    assert res["correct"] is True
    if not trace:
        assert res["metrics"]["setup_s"]["value"] == 9.0
    bad = Outcome(window_start=1.0, end_to_end={"proof_s": 1.0},
                  attempted=1, failed=1, checks={"wrong_points": (1, 0)},
                  memory_peak_bytes=0)
    assert bad.correct is False


def test_module_check_compares_whole_top_level_names():
    assert main.forbidden_modules(["jax.numpy", "numpy"]) == ["jax"]
    assert main.forbidden_modules(["bazuka_tpu.ops.ntt"]) == ["bazuka_tpu"]
    assert main.forbidden_modules(["jaxlib", "flax.linen"]) == [
        "flax", "jaxlib"]
    assert main.forbidden_modules(
        ["bazuka_tpu_torch", "bazuka_tpu_torch.ops", "jaxtyping",
         "flaxen"]) == []


def digest(folder: Path) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha256(
        p.read_bytes()).hexdigest() for p in sorted(folder.rglob("*"))
        if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_needs_only_new_files(tmp_path, monkeypatch):
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__"))
    before = digest(bench)
    new = json.loads(json.dumps(SPEC))
    new["configs"].append({
        "name": "mainnet_copy", "source": SPEC["configs"][0]["source"],
        "file": "benchmark/configs/mainnet_copy.json", "reduced": [],
        "why": "a later configuration"})
    new["workloads"].append({
        "name": "mainnet_copy.deposit.full", "config": "mainnet_copy",
        "traffic": "deposit.full", "chips": 1, "why": "a later cell"})
    new["end_to_end"][0]["workloads"].append("mainnet_copy.deposit.full")
    new["per_layer"].append({
        "name": "prover.setup_s", "unit": "s", "better": "lower",
        "source": "program_span", "layer": "prover", "moves": "proof_s",
        "workloads": ["mainnet_copy.deposit.full"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    conf = json.loads((bench / "configs" / "mainnet.json").read_text())
    conf["name"] = "mainnet_copy"
    (bench / "configs" / "mainnet_copy.json").write_text(json.dumps(conf))
    (bench / "traffic" / "deposit.full.json").write_text(json.dumps(
        {"driver": "prove", "circuit": "deposit", "accounts": 64,
         "enabled": 64, "deposit": [1, 9], "amount": [1, 1], "fee": [0, 0]}))
    (bench / "metrics" / "prover.setup_s.py").write_text(
        "def read(layer):\n    return layer['stages'][0]['setup']\n")
    monkeypatch.setattr(spec, "BENCH", bench)
    cell = spec.Cell(tmp_path, "mainnet_copy.deposit.full")
    assert cell.config["name"] == "mainnet_copy"
    assert cell.traffic["circuit"] == "deposit"
    assert cell.driver().__name__ == "harness.drivers.prove"
    assert [m["name"] for m in cell.end_to_end] == ["proof_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["prover.setup_s"]
    assert spec.reader("prover.setup_s")(
        {"stages": [{"setup": 0.25}]}) == 0.25
    after = digest(bench)
    assert {k: after[k] for k in before} == before
