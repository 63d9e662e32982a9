"""Sparse R1CS evaluation on the device (port of
`bazuka_tpu/groth16/sparse.py`: `DeviceR1CS` and `encode_mont`):

  * row evaluation    a_j = Σ_i A[j,i]·z_i       (per proof, prove.py)
  * column evaluation u_i(τ) = Σ_j A[j,i]·L_j(τ)  (once, keygen.py)

Both are one plan per matrix: gather the table and palette operands of
every term, one batched Montgomery multiply (kernel K1 on the card), then a
segmented sum over rows or over columns.
The JAX version sums in uint32 with a two-level split to avoid overflow;
here the products' 16-bit limbs are summed with `index_add_` into int64, so
one level holds up to 2^31 terms per segment (limb sums < 2^47; the densest
segment is the ONE column, about 1.6M terms at d = 2^22).  Integer adds are
exact in any order, so atomics on the card give the same result every run.  The int64 sums fold back to canonical Montgomery form with three
multiplies: a limb sum s = lo + 2^16·mid + 2^32·hi, and
lo·(R mod p), mid·(2^16·R mod p), hi·(2^32·R mod p) are each REDC'd to the
residue of their part.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..device import resolve_device
from ..fields.limbs import fr_field
from .r1cs import CompiledR1CS

_TCHUNK = 1 << 22  # terms per gather/multiply pass (bounds the transients)


def _fold_consts(device):
    F = fr_field()
    vals = [F.R_mod_p, (1 << 16) * F.R_mod_p % F.p, (1 << 32) * F.R_mod_p % F.p]
    return F.encode(np.array(vals, dtype=object), mont=False, device=device)


def redundant_reduce(s64: torch.Tensor) -> torch.Tensor:
    """(B, 16) int64 limbs, each < 2^48 -> canonical (B, 16) int32
    Montgomery element of the same residue."""
    F = fr_field()
    parts = torch.stack([s64 & 0xFFFF, (s64 >> 16) & 0xFFFF, s64 >> 32])
    folded = F.mont_mul(parts.to(torch.int32),
                        _fold_consts(s64.device)[:, None, :])
    return F.add(F.add(folded[0], folded[1]), folded[2])


class _MatPlan:
    """One sparse matrix x one segmentation, index arrays on the device."""

    def __init__(self, op_idx, cids, seg_ids, n_seg, device):
        counts = np.bincount(seg_ids, minlength=n_seg) if len(seg_ids) else [0]
        if int(np.max(counts)) >= 1 << 31:
            raise ValueError("a segment holds 2^31 terms or more")
        self.T = int(op_idx.shape[0])
        self.n_seg = n_seg
        self.device = device
        self.op_idx = torch.from_numpy(op_idx.astype(np.int64)).to(device)
        self.cid_idx = torch.from_numpy(cids.astype(np.int64)).to(device)
        self.seg = torch.from_numpy(seg_ids.astype(np.int64)).to(device)

    def eval(self, tbl_mont, pal_mont):
        F = fr_field()
        acc = torch.zeros((self.n_seg, F.n), dtype=torch.int64,
                          device=tbl_mont.device)
        for lo in range(0, self.T, _TCHUNK):
            hi = min(lo + _TCHUNK, self.T)
            prod = F.mont_mul(tbl_mont[self.op_idx[lo:hi]],
                              pal_mont[self.cid_idx[lo:hi]])
            acc.index_add_(0, self.seg[lo:hi], prod.to(torch.int64))
        return redundant_reduce(acc)


class DeviceR1CS:
    """Compiled circuit matrices uploaded once, evaluated per proof.

    The A matrix is extended with the per-input rows (input_i)·0 = 0 that
    make input polynomials linearly independent (bellman's domain layout)."""

    def __init__(self, compiled: CompiledR1CS, device="cuda"):
        self.c = compiled
        self.device = resolve_device(device)
        F = fr_field()
        n, ni = compiled.n_constraints, compiled.num_inputs
        self.n_rows = n + ni  # extended
        pal = np.array(compiled.palette, dtype=object)
        self.pal_mont = F.encode(pal, mont=True, device=self.device)

        one_cid = compiled.palette.index(1)
        ext_rows = np.arange(n, n + ni, dtype=np.int32)
        ext_vars = np.arange(ni, dtype=np.int32)
        ext_cids = np.full(ni, one_cid, dtype=np.int32)
        self._mats = []
        for m in range(3):
            rows, vars_, cids = (
                compiled.rows[m], compiled.vars[m], compiled.cids[m],
            )
            if m == 0:
                rows = np.concatenate([rows, ext_rows])
                vars_ = np.concatenate([vars_, ext_vars])
                cids = np.concatenate([cids, ext_cids])
            self._mats.append((rows, vars_, cids))
        # plans are built lazily: the prover needs only row plans, keygen
        # only column plans
        self._row_plans: List[_MatPlan] = []
        self._col_plans: List[_MatPlan] = []

    @property
    def row_plans(self):
        if not self._row_plans:
            self._row_plans = [
                _MatPlan(v, c, r, self.n_rows, self.device)
                for r, v, c in self._mats
            ]
        return self._row_plans

    @property
    def col_plans(self):
        if not self._col_plans:
            self._col_plans = [
                _MatPlan(r, c, v, self.c.num_vars, self.device)
                for r, v, c in self._mats
            ]
        return self._col_plans

    def eval_rows(self, z_mont):
        """z_mont: (num_vars, 16) mont limbs -> 3x(n_rows, 16) mont evals."""
        return tuple(p.eval(z_mont, self.pal_mont) for p in self.row_plans)

    def eval_cols(self, L_mont):
        """L_mont: (n_rows, 16) mont Lagrange values at τ -> u, v, w per
        variable, 3x(num_vars, 16) mont limbs."""
        return tuple(p.eval(L_mont, self.pal_mont) for p in self.col_plans)


def encode_mont(vals, device="cuda"):
    """Host ints -> device Montgomery limbs: the byte path on the host and
    one to_mont multiply on the device."""
    F = fr_field()
    return F.to_mont(F.encode(np.array(vals, dtype=object), mont=False,
                              device=device))
