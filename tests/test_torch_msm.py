"""Port MSMs (`bazuka_tpu_torch.ops.msm_lm`: the v3 drain and the
duplicate-scalar presum) against naive host sums, on the cases of
tests/test_msm.py and tests/test_msm_dedup.py: duplicates, zeros,
infinities, c = 4/8/12, several chunks, G2.  The dedup plan is held
against the JAX package's plan field by field; the live comparison with
the JAX MSM is in the slow tier, as the JAX MSM tests are."""

import numpy as np
import pytest
import torch

from bazuka_tpu.crypto import bls12_381 as bls
from bazuka_tpu_torch.fields.limbs import to_numpy
from bazuka_tpu_torch.ops import msm_lm as tm

# The shapes here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

N = 16
CPU = "cpu"


def naive(kind, points, scalars):
    add, mul = ((bls.g1_add, bls.g1_mul) if kind == "g1"
                else (bls.g2_add, bls.g2_mul))
    acc = None
    for p, s in zip(points, scalars):
        acc = add(acc, mul(p, s))
    return acc


def port_msm(kind, pts, scalars, plan_threshold=None, **kw):
    if kind == "g1":
        P, inf = tm.points_to_am(pts, device=CPU)
    else:
        P, inf = tm.points_to_am_g2(pts, device=CPU)
    s = tm.enc_scalars(scalars, device=CPU)
    plan = None
    if plan_threshold is not None:
        plan = tm.make_dedup_plan(to_numpy(s), threshold=plan_threshold)
        assert plan.active
    run = tm.msm_lm if kind == "g1" else tm.msm_lm_g2
    return run(P, inf, s, dedup_plan=plan, **kw)


def pad16(pts, scalars):
    return pts + [None] * (N - len(pts)), scalars + [0] * (N - len(scalars))


def _random_case(seed):
    rng = np.random.default_rng(seed)
    pts = [bls.g1_mul(bls.G1_GEN, int(k)) for k in rng.integers(1, 2**30, N)]
    scalars = [(int(a) << 192 | int(b) << 128 | int(c) << 64 | int(d)) % bls.R
               for a, b, c, d in rng.integers(0, 2**63, size=(N, 4))]
    return pts, scalars, 255


G = [bls.g1_mul(bls.G1_GEN, k) for k in range(1, 17)]
CASES = {
    "small": pad16(G[:4], [0, 1, 2, 3]) + (64,),
    "skewed": (G, [0] * 8 + [1] * 4 + [bls.R - 1] * 3 + [12345], 255),
    "zeros": (G, [0] * 16, 64),
    "infinity": pad16([bls.G1_GEN, None, bls.g1_double(bls.G1_GEN), None],
                      [3, 5, 7, 0]) + (64,),
    "random": _random_case(0),
    "v3_dups": ([None if i == 3 else p for i, p in enumerate(G)],
                [7, 7, 7, 5, 0, 0, 1, 2**63 - 1] + list(range(11, 19)), 64),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_msm_g1(name):
    pts, scalars, nbits = CASES[name]
    assert port_msm("g1", pts, scalars, c=4, nbits=nbits) == naive(
        "g1", pts, scalars)


@pytest.mark.parametrize("c, nbits", [(8, 64), (12, 24)])
def test_msm_g1_wide_windows(c, nbits):
    """c = 12 at 24 bits: two windows, the second across a limb edge."""
    pts, scalars, _ = CASES["random"]
    scalars = [s % 2**nbits for s in scalars]
    assert port_msm("g1", pts, scalars, c=c, nbits=nbits) == naive(
        "g1", pts, scalars)


def test_msm_g1_multichunk():
    """Bucket runs split across chunk boundaries merge exactly."""
    scalars = [3] * 10 + list(range(100, 106))
    assert port_msm("g1", G, scalars, c=4, nbits=64, chunk=8) == naive(
        "g1", G, scalars)


def test_msm_g2():
    rng = np.random.default_rng(3)
    pts = [bls.g2_mul(bls.G2_GEN, int(k)) for k in rng.integers(1, 2**20, 8)]
    scalars = [int(s) for s in rng.integers(0, 2**63, 8)]
    pts[2] = None
    assert port_msm("g2", pts, scalars, c=4, nbits=64) == naive(
        "g2", pts, scalars)


def _dup_instance(n, seed=0):
    """~60% of scalars drawn from 4 heavy values (incl. 0 and 1)."""
    rng = np.random.default_rng(seed)
    pts = [bls.g1_mul(bls.G1_GEN, k + 1) for k in range(n)]
    heavy = [0, 1, 2, 77]
    scalars = [heavy[rng.integers(0, 4)] if rng.random() < 0.6
               else int(rng.integers(1, 2**62)) * 0x1000193 % bls.R
               for _ in range(n)]
    return pts, scalars


def test_msm_dedup_matches_oracle():
    pts, scalars = _dup_instance(256)
    pts[9] = None  # an infinity row inside a heavy group
    assert port_msm("g1", pts, scalars, plan_threshold=8, c=4) == naive(
        "g1", pts, scalars)


def test_msm_dedup_all_same_scalar():
    pts = [bls.g1_mul(bls.G1_GEN, 3 * k + 2) for k in range(128)]
    scalars = [12345] * 128
    assert port_msm("g1", pts, scalars, plan_threshold=8, c=4) == naive(
        "g1", pts, scalars)


def test_g2_msm_dedup_matches_oracle():
    rng = np.random.default_rng(1)
    pts = [bls.g2_mul(bls.G2_GEN, k + 1) for k in range(64)]
    scalars = [1 if rng.random() < 0.5 else int(rng.integers(1, 2**62))
               for _ in range(64)]
    assert port_msm("g2", pts, scalars, plan_threshold=4, c=4) == naive(
        "g2", pts, scalars)


def test_dedup_plan_matches_jax():
    """Same grouping, runs and fold masks as the JAX package's planner,
    for the plan and for its input-shifted derivative.  The port pads the
    run lanes to a multiple of 8 (its kernels take any lane count), the
    JAX planner to its 1024-lane tile: the lanes past the shorter padding
    hold only empty runs."""
    from bazuka_tpu.ops import pallas_msm as jpm

    _, scalars = _dup_instance(512, seed=3)
    s_np = to_numpy(tm.enc_scalars(scalars, device=CPU))
    mine, ref = tm.make_dedup_plan(s_np, 8), jpm.make_dedup_plan(s_np, 8)
    for a, b in ((mine, ref), (mine.derive_shifted(5), ref.derive_shifted(5))):
        assert a.n_heavy_vals == b.n_heavy_vals
        assert (a.m, a.Hp, a.n_heavy_elems) == (b.m, b.Hp, b.n_heavy_elems)
        for field in ("hpos", "heavy_scalars", "first_lane"):
            assert np.array_equal(np.asarray(getattr(a, field), np.int64),
                                  np.asarray(getattr(b, field), np.int64))
        ks, nr = a.Ks, a.fold_masks.shape[0]
        assert np.array_equal(a.run_len, np.asarray(b.run_len)[:ks])
        assert not np.asarray(b.run_len)[ks:].any()
        live = a.run_len > 0
        assert np.array_equal(a.run_start[live],
                              np.asarray(b.run_start)[:ks][live])
        b_masks = np.asarray(b.fold_masks) != 0
        assert np.array_equal(a.fold_masks, b_masks[:nr, :ks])
        assert not b_masks[:, ks:].any() and not b_masks[nr:].any()


@pytest.mark.parametrize("clash", [False, True], ids=["hashed", "clash"])
def test_heavy_groups_match_exact_sort(clash, monkeypatch):
    """The hashed grouping gives the void-row sort's groups, labels and
    value order (values that differ only in high limbs included); with
    every row hashing alike it detects the clash and the plan comes from
    the exact path, unchanged."""
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 1 << 16, (4096, 16), dtype=np.uint32)
    rows[rng.random(4096) < 0.3] = 0
    ones = rng.random(4096) < 0.3
    rows[ones] = 0
    rows[ones, 0] = 1
    for k in range(12):  # groups on both sides of the threshold
        rows[rng.integers(0, 4096, k + 3)] = rng.integers(
            0, 1 << 16, 16, dtype=np.uint32)
    rows[:12] = 0
    rows[:12, 15] = 7
    rows[12:24] = 0
    rows[12:24, 15] = 3
    want = tm._heavy_groups_exact(rows, 8)
    assert want[2].shape[0] >= 5
    if clash:
        monkeypatch.setattr(tm, "_ROW_HASH_MUL", np.zeros(16, np.uint64))
        assert tm._heavy_groups_hashed(rows, 8) is None
    else:
        for a, b in zip(tm._heavy_groups_hashed(rows, 8), want):
            assert np.array_equal(a, b)
    plan = tm.make_dedup_plan(rows, 8)
    assert np.array_equal(plan.heavy_scalars, want[2])
    assert np.array_equal(np.sort(plan.hpos), want[0])


def test_pad_len():
    assert [tm.msm_pad_len(n) for n in (1, 16, 17, 1 << 18, (1 << 18) + 1)] \
        == [16, 16, 32, 1 << 18, 1 << 19]


@pytest.mark.slow
def test_matches_jax_msm_live():
    from bazuka_tpu.ops import pallas_msm as jpm
    from bazuka_tpu.ops.msm import _enc_scalars

    pts, scalars = _dup_instance(256, seed=5)
    P_am, inf = jpm.points_to_am(pts)
    s = _enc_scalars(scalars, "jax")
    plan = jpm.make_dedup_plan(np.asarray(s), threshold=8)
    want = jpm.msm_lm(P_am, inf, s, c=4, dedup_plan=plan)
    assert port_msm("g1", pts, scalars, plan_threshold=8, c=4) == want
