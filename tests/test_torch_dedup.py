"""The dedup plan's native grouping pass (`bazuka_tpu_torch/ops/msm_lm.py`,
`csrc/dedup.cpp`) on the CPU.

- Its groups, labels and value order equal the void-row sort's
  (`_heavy_groups_exact`), and its members ordered by label equal a stable
  argsort of the labels: on random rows, groups on both sides of the
  threshold, values that differ only in high limbs, zero rows and small
  values, no heavy value and a single row.
- Every path builds the same plan, array for array, as the exact grouping:
  the native pass from uint16 and from uint32 rows (no `dedup.fallback`);
  numpy where a uint32 limb is 2^16 or more, where the hash multipliers
  are zeroed (a clash the pass detects) and where the loader gives None,
  each counting `dedup.fallback` once.
- The toy key's proof at pinned (r, s), its five witness values all heavy
  (threshold 0), is the pinned bytes with the native pass and with the
  loader forced to None.

The native pass needs a C++ compiler; where none exists, the tests that
need it skip and say so.
"""

import functools
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from bazuka_tpu_torch.groth16 import keygen, prove
from bazuka_tpu_torch.ops import msm_lm as tm
from bazuka_tpu_torch.utils import ser, spans

# The toy shapes are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

PLAN_FIELDS = ("n_heavy_vals", "active", "n_heavy_elems", "m", "Hp", "Ks",
               "hpos", "_lab", "heavy_scalars", "run_start", "run_len",
               "fold_masks", "first_lane")


@pytest.fixture
def native():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no C++ compiler to build csrc/dedup.cpp")
    assert tm.load_grouper() is not None


@pytest.fixture
def no_loader(monkeypatch):
    monkeypatch.setattr(tm, "load_grouper", lambda: None)


GROUP_CASES = ["random", "threshold_edges", "high_limbs", "zeros_and_small",
               "none_heavy", "single_row"]


def newest(name):
    return [c for c in spans.snapshot() if c["name"] == name][-1]


def _value(rng, high_only=False):
    v = rng.integers(0, 1 << 16, 16, dtype=np.uint32)
    if high_only:
        v[:8] = 0
    return v


def rows_of(case: str):
    """(N, 16) uint32 rows and a threshold for each case."""
    rng = np.random.default_rng(GROUP_CASES.index(case))
    if case == "single_row":
        return np.array([[5] + [0] * 14 + [9]], np.uint32), 0
    rows = rng.integers(0, 1 << 16, (3000, 16), dtype=np.uint32)
    if case == "random":
        for n in rng.integers(1, 30, 40):  # random values, random counts
            rows[rng.integers(0, 3000, n)] = _value(rng)
    elif case == "threshold_edges":  # 8 and 9 members, small and hashed
        for k, (n, small) in enumerate([(8, True), (9, True), (8, False),
                                        (9, False), (20, True),
                                        (20, False)]):
            rows[100 * k:100 * k + n] = 0 if small else _value(rng)
            if small:
                rows[100 * k:100 * k + n, 0] = k + 2
    elif case == "high_limbs":  # equal low limbs, then equal but limb 15
        base = _value(rng, high_only=True)
        for k in range(6):
            v = base.copy()
            v[15] = k
            rows[50 * k:50 * k + 10 + k] = v
        rows[400:420] = 0
        rows[400:420, 15] = 1
        rows[420:440] = 0
        rows[420:440, 0] = 1
        rows[440:460] = 0
        rows[440:460, 1] = 1
    elif case == "zeros_and_small":
        u = rng.random(3000)
        rows[u < 0.3] = 0
        small = u >= 0.6
        rows[small] = 0
        rows[small, 0] = rng.choice([1, 2, 3, 65535], small.sum())
    elif case == "none_heavy":  # every value below the threshold
        for k in range(30):
            rows[10 * k:10 * k + 8] = _value(rng)
        rows[2000:2008] = 0
        rows[2000:2008, 0] = 1
    return rows, 8


@pytest.mark.parametrize("case", GROUP_CASES)
def test_native_groups_equal_exact_sort(case, native):
    rows, threshold = rows_of(case)
    want = tm._heavy_groups_exact(rows, threshold)
    if case == "none_heavy":
        assert want[2].shape[0] == 0
    else:
        assert want[2].shape[0] >= 1
    got = tm._heavy_groups_native(rows.astype(np.uint16), threshold)
    assert got is not None
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    order = np.argsort(want[1], kind="stable")
    assert np.array_equal(got[3], want[0][order])


def exact_plan(rows, threshold):
    hm_pos, labels, vals = tm._heavy_groups_exact(
        np.ascontiguousarray(rows, np.uint32), threshold)
    order = np.argsort(labels, kind="stable")
    return tm._DedupPlan(None, _parts=(hm_pos[order], labels[order], vals))


def same_plan(a, b):
    for f in PLAN_FIELDS:
        if not b.active and f not in ("n_heavy_vals", "active"):
            continue
        x, y = getattr(a, f), getattr(b, f)
        assert np.asarray(x).dtype == np.asarray(y).dtype, f
        assert np.array_equal(x, y), f


@pytest.mark.parametrize("path", ["uint16", "uint32", "wide_limb", "clash",
                                  "no_loader"])
def test_plan_equal_on_every_path(path, request, monkeypatch):
    request.getfixturevalue("no_loader" if path == "no_loader" else "native")
    rows, _ = rows_of("threshold_edges")
    if path == "wide_limb":
        rows[2500, 3] = 1 << 16
    if path == "clash":
        monkeypatch.setattr(tm, "_ROW_HASH_MUL", np.zeros(16, np.uint64))
        assert tm._heavy_groups_native(rows.astype(np.uint16), 8) is None
    s_np = rows.astype(np.uint16) if path == "uint16" else rows
    with spans.call("dedup-test"):
        plan = tm.make_dedup_plan(s_np, 8)
    same_plan(plan, exact_plan(rows, 8))
    assert plan.n_heavy_vals >= 3
    c = newest("dedup-test")
    native_ran = path in ("uint16", "uint32", "clash")
    assert c["counts"].get("dedup.group") == (1 if native_ran else None)
    assert c["counts"].get("dedup.fallback") == (
        None if path in ("uint16", "uint32") else 1)


@pytest.fixture(scope="module")
def toy_params():
    return keygen.load_parameters(chip_smoke.TOY_KEY, device="cpu")


def test_toy_proof_bytes_with_and_without_the_pass(native, toy_params,
                                                   monkeypatch):
    """Threshold 0 makes each of the toy witness's nonzero values heavy,
    so every MSM of the proof takes its scalars from the plan."""
    monkeypatch.setattr(prove.msm, "make_dedup_plan",
                        functools.partial(tm.make_dedup_plan, threshold=0))
    fallbacks = []
    for forced in (False, True):
        if forced:
            monkeypatch.setattr(tm, "load_grouper", lambda: None)
        cs, _ = chip_smoke.toy_circuit()
        record = {}
        proof = prove.create_proof(toy_params, cs, r=7, s=11, device="cpu",
                                   record=record)
        assert record["n_heavy_vals"] == 5
        assert ser.dumps(proof).hex() == chip_smoke.TOY_PROOF_HEX
        fallbacks.append(newest("create_proof")["counts"].get(
            "dedup.fallback"))
    assert fallbacks == [None, 1]
