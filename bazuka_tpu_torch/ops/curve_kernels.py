"""Kernels K2-K7: complete curve addition on limb-major points.

K2-K5 add with a per-lane select, out = mask ? acc + Q : acc:

  K2 madd_select_lm     G1, acc (3, 24, L) projective, Q (2, 24, L) affine
  K3 add_select_lm      G1, acc and Q (3, 24, L) projective
  K4 madd_select_g2_lm  G2, acc (6, 24, L), Q (4, 24, L) affine
  K5 add_select_g2_lm   G2, acc and Q (6, 24, L)

K6-K7 add with no select, out = P + Q, all projective:

  K6 g1_add_lm          G1, P and Q (3, 24, L)
  K7 g2_add_lm          G2, P and Q (6, 24, L)

K2-K5 replace the Pallas kernels `_g1_madd_select_call`,
`_g1_add_select_call`, `_g2_madd_select_call` and `_g2_add_select_call` of
`bazuka_tpu/ops/pallas_msm.py` (CUDA source `csrc/rcb15_select.cu`); K6-K7
replace `_g1_add_call` and `_g2_add_call` of `bazuka_tpu/ops/pallas_curve.py`
(CUDA source `csrc/curve_add.cu`).  For K2-K5, `mask` is a (L,) bool tensor;
lanes where Q is infinity must be masked off by the caller (affine form
cannot encode it).  L is any length: the kernels bounds-check their lanes.

Each wrapper runs its plain version on a CPU tensor and launches its
kernel on a CUDA tensor, or raises.  The plain versions are `proj_add`
(+ `proj_select` for K2-K5) with the plain Montgomery multiply, as the JAX
fallbacks at `pallas_msm.py:152-164`, :435-451, :469-478 and :514-523, and
the jnp `proj_add` that `pallas_curve.py`'s kernels fuse.
"""

from __future__ import annotations

import torch

from ..fields.limbs import FP_LIMBS, fp_field
from . import _cuda
from . import weierstrass as wst

_SRC = "rcb15_select.cu"
_PALLAS = "bazuka_tpu/ops/pallas_msm.py"
K_G1_MADD = _cuda.register(_cuda.CudaKernel(
    "g1_madd_select", _SRC, "bz_g1_madd_select", 4, f"{_PALLAS}:72"))
K_G1_ADD = _cuda.register(_cuda.CudaKernel(
    "g1_add_select", _SRC, "bz_g1_add_select", 4, f"{_PALLAS}:238"))
K_G2_MADD = _cuda.register(_cuda.CudaKernel(
    "g2_madd_select", _SRC, "bz_g2_madd_select", 4, f"{_PALLAS}:305"))
K_G2_ADD = _cuda.register(_cuda.CudaKernel(
    "g2_add_select", _SRC, "bz_g2_add_select", 4, f"{_PALLAS}:359"))
K_G1_FULL = _cuda.register(_cuda.CudaKernel(
    "g1_add", "curve_add.cu", "bz_g1_add", 3,
    "bazuka_tpu/ops/pallas_curve.py:101"))
K_G2_FULL = _cuda.register(_cuda.CudaKernel(
    "g2_add", "curve_add.cu", "bz_g2_add", 3,
    "bazuka_tpu/ops/pallas_curve.py:167"))


# ------------------------------------------------------------ plain versions


def _g1_lm_to_wst(a):
    return tuple(a[i].T for i in range(a.shape[0]))


def _g1_wst_to_lm(P):
    return torch.stack([c.T for c in P]).contiguous()


def _g2_lm_to_wst(a):
    return tuple((a[2 * i].T, a[2 * i + 1].T) for i in range(a.shape[0] // 2))


def _g2_wst_to_lm(P):
    return torch.stack([c.T for pair in P for c in pair]).contiguous()


def madd_select_lm_plain(acc, pts_aff, mask):
    K = wst.fp_ops(plain=True)
    one = fp_field().ones_mont((acc.shape[-1],), acc.device)
    P = _g1_lm_to_wst(acc)
    Q = (pts_aff[0].T, pts_aff[1].T, one)
    R = wst.proj_add(K, P, Q, wst.g1_b3(acc.device))
    return _g1_wst_to_lm(wst.proj_select(K, mask, R, P))


def add_select_lm_plain(acc, pts, mask):
    K = wst.fp_ops(plain=True)
    P = _g1_lm_to_wst(acc)
    R = wst.proj_add(K, P, _g1_lm_to_wst(pts), wst.g1_b3(acc.device))
    return _g1_wst_to_lm(wst.proj_select(K, mask, R, P))


def madd_select_g2_lm_plain(acc, pts_aff, mask):
    K = wst.fp2_ops(plain=True)
    F = fp_field()
    L = acc.shape[-1]
    P = _g2_lm_to_wst(acc)
    Q = ((pts_aff[0].T, pts_aff[1].T), (pts_aff[2].T, pts_aff[3].T),
         (F.ones_mont((L,), acc.device), F.zeros((L,), acc.device)))
    R = wst.proj_add(K, P, Q, wst.g2_b3(acc.device))
    return _g2_wst_to_lm(wst.proj_select(K, mask, R, P))


def add_select_g2_lm_plain(acc, pts, mask):
    K = wst.fp2_ops(plain=True)
    P = _g2_lm_to_wst(acc)
    R = wst.proj_add(K, P, _g2_lm_to_wst(pts), wst.g2_b3(acc.device))
    return _g2_wst_to_lm(wst.proj_select(K, mask, R, P))


def g1_add_lm_plain(p, q):
    K = wst.fp_ops(plain=True)
    return _g1_wst_to_lm(wst.proj_add(K, _g1_lm_to_wst(p), _g1_lm_to_wst(q),
                                      wst.g1_b3(p.device)))


def g2_add_lm_plain(p, q):
    K = wst.fp2_ops(plain=True)
    return _g2_wst_to_lm(wst.proj_add(K, _g2_lm_to_wst(p), _g2_lm_to_wst(q),
                                      wst.g2_b3(p.device)))


# ------------------------------------------------------------ wrappers


def _check_points(L: int, named):
    for name, t, planes in named:
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 limbs, got {t.dtype}")
        if tuple(t.shape) != (planes, FP_LIMBS, L):
            raise ValueError(f"{name} shape {tuple(t.shape)}, want "
                             f"({planes}, {FP_LIMBS}, {L})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if len({t.device for _, t, _ in named}) != 1:
        raise ValueError("all operands must share one device")


def _dispatch(kernel, plain, acc, pts, mask, n_acc, n_q):
    L = acc.shape[-1]
    if mask.dtype != torch.bool or tuple(mask.shape) != (L,):
        raise ValueError(f"mask must be a ({L},) bool tensor")
    if not mask.is_contiguous():
        raise ValueError("mask must be contiguous")
    _check_points(L, (("acc", acc, n_acc), ("pts", pts, n_q)))
    if acc.device != mask.device:
        raise ValueError("acc, pts and mask must share one device")
    if acc.device.type == "cpu":
        return plain(acc, pts, mask)
    if acc.device.type != "cuda":
        raise ValueError(f"unsupported device {acc.device}")
    out = torch.empty_like(acc)
    if L:
        kernel.launch((acc, pts, mask, out), L)
    return out


def madd_select_lm(acc, pts_aff, mask):
    """G1: mask ? acc + Q : acc with Q affine.  Returns (3, 24, L)."""
    return _dispatch(K_G1_MADD, madd_select_lm_plain, acc, pts_aff, mask, 3, 2)


def add_select_lm(acc, pts, mask):
    """G1: mask ? acc + Q : acc, both projective.  Returns (3, 24, L)."""
    return _dispatch(K_G1_ADD, add_select_lm_plain, acc, pts, mask, 3, 3)


def madd_select_g2_lm(acc, pts_aff, mask):
    """G2: mask ? acc + Q : acc with Q affine.  Returns (6, 24, L)."""
    return _dispatch(K_G2_MADD, madd_select_g2_lm_plain, acc, pts_aff, mask,
                     6, 4)


def add_select_g2_lm(acc, pts, mask):
    """G2: mask ? acc + Q : acc, both projective.  Returns (6, 24, L)."""
    return _dispatch(K_G2_ADD, add_select_g2_lm_plain, acc, pts, mask, 6, 6)


def _add_dispatch(kernel, plain, p, q, planes):
    L = p.shape[-1]
    _check_points(L, (("p", p, planes), ("q", q, planes)))
    if p.device.type == "cpu":
        return plain(p, q)
    if p.device.type != "cuda":
        raise ValueError(f"unsupported device {p.device}")
    out = torch.empty_like(p)
    if L:
        kernel.launch((p, q, out), L)
    return out


def g1_add_lm(p, q):
    """G1: P + Q, both projective (3, 24, L).  Returns (3, 24, L)."""
    return _add_dispatch(K_G1_FULL, g1_add_lm_plain, p, q, 3)


def g2_add_lm(p, q):
    """G2: P + Q, both projective (6, 24, L).  Returns (6, 24, L)."""
    return _add_dispatch(K_G2_FULL, g2_add_lm_plain, p, q, 6)
