"""Port parity: the plain versions of kernels K2-K5
(`bazuka_tpu_torch.ops.curve_kernels`) against `bazuka_tpu.ops.pallas_msm`'s
`madd_select_lm`, `add_select_lm`, `madd_select_g2_lm` and
`add_select_g2_lm` (their jnp fallbacks on the CPU), and the projective to
affine conversions against `bazuka_tpu.ops.weierstrass`.

L = 1024 lanes with the edge cases complete addition must handle: P = 0,
P = Q (doubling), P = -Q, Q = 0 (projective Q only) and masked-off lanes.
Points are compared in affine form, and against host arithmetic."""

import numpy as np
import pytest
import torch

from bazuka_tpu.crypto import bls12_381 as bls
from bazuka_tpu.fields.host import FP
from bazuka_tpu.ops import pallas_msm as jpm
from bazuka_tpu.ops import weierstrass as jw
from bazuka_tpu_torch.fields.limbs import fp_field, to_numpy, to_torch
from bazuka_tpu_torch.ops import curve_kernels as ck
from bazuka_tpu_torch.ops import weierstrass as tw

# The shapes here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

L = 1024
CPU = "cpu"


def host_points(kind, a, b, n):
    """(a + i·b)·G for i < n by host additions."""
    gen, add, mul = ((bls.G1_GEN, bls.g1_add, bls.g1_mul) if kind == "g1"
                     else (bls.G2_GEN, bls.g2_add, bls.g2_mul))
    p, step = mul(gen, a), mul(gen, b)
    out = []
    for _ in range(n):
        out.append(p)
        p = add(p, step)
    return out


def _planes(kind, pts, lam, proj):
    """Host points -> Montgomery ints per plane; projective coordinates
    scaled by lam (Z = lam), the identity as (0, 1, 0)."""
    planes = []
    for p, s in zip(pts, lam):
        if kind == "g1":
            c = [0, 1, 0] if p is None else [p[0] * s, p[1] * s, s]
            planes.append(c if proj else c[:2])
        else:
            c = ([0, 0, 1, 0, 0, 0] if p is None else
                 [p[0][0] * s, p[0][1] * s, p[1][0] * s, p[1][1] * s, s, 0])
            planes.append(c if proj else c[:4])
    arr = np.array(planes, dtype=object).T % FP.p
    return to_numpy(fp_field().encode(arr, device=CPU))  # (planes, L, 24)


def to_lm(arr):
    """(planes, L, 24) uint32 -> limb-major (planes, 24, L)."""
    return np.ascontiguousarray(arr.transpose(0, 2, 1))


def from_lm(kind, lm):
    """Limb-major projective limbs -> host affine points."""
    lm = np.asarray(lm, np.uint32)
    K = jw.fp_ops("np") if kind == "g1" else jw.fp2_ops("np")
    if kind == "g1":
        return jw.g1_from_proj(K, tuple(lm[i].T for i in range(3)))
    return jw.g2_from_proj(K, tuple((lm[2 * i].T, lm[2 * i + 1].T)
                                    for i in range(3)))


def case(kind, seed):
    rng = np.random.default_rng(seed)
    P = host_points(kind, 5 + seed, 7, L)
    Q = host_points(kind, 11 + seed, 13, L)
    P = list(P)
    for i in range(0, L, 8):
        P[i] = None                                   # P = identity
        P[i + 1] = Q[i + 1]                           # doubling
        P[i + 2] = (bls.g1_neg if kind == "g1" else bls.g2_neg)(Q[i + 2])
    Qp = list(Q)
    for i in range(4, L, 8):
        Qp[i] = None                                  # Q = identity
    lam_p = [int(x) for x in rng.integers(1, 2**62, L)]
    lam_q = [int(x) for x in rng.integers(1, 2**62, L)]
    mask = (np.arange(L) % 8 != 3) & (rng.random(L) < 0.9)
    acc = to_lm(_planes(kind, P, lam_p, True))
    q_aff = to_lm(_planes(kind, Q, [1] * L, False))
    q_proj = to_lm(_planes(kind, Qp, lam_q, True))
    return P, Q, Qp, acc, q_aff, q_proj, mask


def expected(kind, P, Q, mask):
    add = bls.g1_add if kind == "g1" else bls.g2_add
    return [add(p, q) if m else p for p, q, m in zip(P, Q, mask)]


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_add_select_plain_matches_jax(kind):
    P, Q, Qp, acc, q_aff, q_proj, mask = case(kind, 1 if kind == "g1" else 2)
    if kind == "g1":
        t_madd, t_add = ck.madd_select_lm, ck.add_select_lm
        j_madd, j_add = jpm.madd_select_lm, jpm.add_select_lm
    else:
        t_madd, t_add = ck.madd_select_g2_lm, ck.add_select_g2_lm
        j_madd, j_add = jpm.madd_select_g2_lm, jpm.add_select_g2_lm
    t_acc, t_mask = to_torch(acc, CPU), torch.from_numpy(mask)
    j_mask = mask.astype(np.uint32)
    for t_fn, j_fn, q, qpts in ((t_madd, j_madd, q_aff, Q),
                                (t_add, j_add, q_proj, Qp)):
        got = from_lm(kind, to_numpy(t_fn(t_acc, to_torch(q, CPU), t_mask)))
        want = from_lm(kind, np.asarray(j_fn(acc, q, j_mask)))
        assert got == want
        assert got == expected(kind, P, qpts, mask)


def test_wrappers_check_their_inputs():
    acc = torch.zeros((3, 24, 8), dtype=torch.int32)
    q = torch.zeros((2, 24, 8), dtype=torch.int32)
    mask = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError):
        ck.madd_select_lm(acc, acc, mask)  # projective Q to the affine API
    with pytest.raises(TypeError):
        ck.madd_select_lm(acc.to(torch.int64), q, mask)
    with pytest.raises(ValueError):
        ck.madd_select_lm(acc, q, mask[:4])
    with pytest.raises(ValueError):
        ck.add_select_lm(acc.transpose(1, 2).contiguous().transpose(1, 2),
                         acc, mask)


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_proj_to_am_matches_jax(kind):
    pts = host_points(kind, 3, 17, 64)
    pts[5] = None
    lam = [int(x) for x in np.random.default_rng(4).integers(1, 2**62, 64)]
    pl = _planes(kind, pts, lam, True)  # (planes, 64, 24)
    if kind == "g1":
        got = tw.g1_proj_to_am(tuple(to_torch(c, CPU) for c in pl))
        want = jw.g1_proj_to_am(tuple(pl), "jax")
    else:
        got = tw.g2_proj_to_am(tuple(
            (to_torch(pl[2 * i], CPU), to_torch(pl[2 * i + 1], CPU))
            for i in range(3)))
        want = jw.g2_proj_to_am(tuple((pl[2 * i], pl[2 * i + 1])
                                      for i in range(3)), "jax")
    assert np.array_equal(to_numpy(got[0]), np.asarray(want[0], np.uint32))
    assert got[1].tolist() == (np.asarray(want[1]) != 0).tolist()
    assert got[1].tolist() == [p is None for p in pts]
