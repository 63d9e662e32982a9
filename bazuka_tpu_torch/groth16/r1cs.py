"""R1CS constraint system — the gadget substrate, in array form.

A copy of `bazuka_tpu/groth16/r1cs.py`.

Equivalent in role to bellman's `ConstraintSystem` trait consumed by the
reference's circuits (reference: src/mpn/circuits/, src/zk/groth16/gadgets/).
One class serves both modes:
  * setup mode (values absent) — records constraints only, for keygen
  * proving mode (values present) — records constraints AND computes the
    full assignment

Variables are integers: 0 is the constant ONE; 1..num_inputs are public
inputs; the rest are aux (witness).  Linear combinations are dicts
{var: coeff} at the gadget level — small and ergonomic — but `enforce`
flattens them IMMEDIATELY into growing COO term arrays
(row, var, coeff-id), with coefficients deduplicated through a palette:
a mainnet-scale circuit has millions of terms but only thousands of
distinct coefficients (±1, powers of two, Poseidon round constants and
MDS foldings).  This keeps a 10M-constraint system in a few hundred MB
of int32 arrays instead of tens of GB of per-constraint dicts, and
hands the prover/keygen device-ready sparse matrices (SURVEY.md §7
stage 7: vectorized trace evaluation + sparse matvec).
"""

from __future__ import annotations

from array import array
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..fields.host import FR_MODULUS

P = FR_MODULUS

LC = Dict[int, int]  # var index -> coefficient

ONE = 0


def lc(*terms: Tuple[int, int]) -> LC:
    """Build an LC from (var, coeff) pairs, merging duplicates."""
    out: LC = {}
    for var, coeff in terms:
        c = (out.get(var, 0) + coeff) % P
        if c:
            out[var] = c
        else:
            out.pop(var, None)
    return out


def lc_add(a: LC, b: LC) -> LC:
    out = dict(a)
    for var, coeff in b.items():
        c = (out.get(var, 0) + coeff) % P
        if c:
            out[var] = c
        else:
            out.pop(var, None)
    return out


def lc_sub(a: LC, b: LC) -> LC:
    return lc_add(a, lc_scale(b, P - 1))


def lc_scale(a: LC, k: int) -> LC:
    k %= P
    if k == 0:
        return {}
    return {var: coeff * k % P for var, coeff in a.items()}


def lc_const(k: int) -> LC:
    k %= P
    return {ONE: k} if k else {}


class SynthesisError(Exception):
    pass


@dataclass
class CompiledR1CS:
    """Input-major COO form of the three constraint matrices.

    For each matrix m ∈ {A, B, C}: rows[m]/vars[m]/cids[m] are parallel
    int32 arrays of sparse terms, sorted by row (enforce order), with
    vars renumbered so ONE is 0, public inputs 1..num_inputs-1 follow in
    allocation order, and aux variables come after.  palette[cid] is the
    canonical-int coefficient."""

    num_vars: int
    num_inputs: int
    n_constraints: int
    rows: Tuple[np.ndarray, np.ndarray, np.ndarray]
    vars: Tuple[np.ndarray, np.ndarray, np.ndarray]
    cids: Tuple[np.ndarray, np.ndarray, np.ndarray]
    palette: List[int]


class ConstraintSystem:
    """Accumulates constraints a·b = c and (optionally) the assignment."""

    def __init__(self, proving: bool = True):
        self.proving = proving
        # assignment[i] is None in setup mode (except ONE)
        self.assignment: List[Optional[int]] = [1]
        self.num_inputs = 1  # includes ONE
        self.input_indices: List[int] = [0]
        self.n_constraints = 0
        # COO term storage per matrix (row-major by construction)
        self._rows = (array("i"), array("i"), array("i"))
        self._vars = (array("i"), array("i"), array("i"))
        self._cids = (array("i"), array("i"), array("i"))
        self._palette: List[int] = [1]
        self._coeff_ids: Dict[int, int] = {1: 0}

    # ---- allocation

    def alloc(self, value: Optional[int] = None) -> int:
        """Allocate an aux (witness) variable."""
        if self.proving and value is None:
            raise SynthesisError("missing witness value in proving mode")
        idx = len(self.assignment)
        self.assignment.append(value % P if value is not None else None)
        return idx

    def alloc_input(self, value: Optional[int] = None) -> int:
        """Allocate a public input.  Must be called before aux allocations
        are interleaved if input ordering matters (it does: the verifier
        feeds inputs in allocation order)."""
        if self.proving and value is None:
            raise SynthesisError("missing input value in proving mode")
        idx = len(self.assignment)
        self.assignment.append(value % P if value is not None else None)
        self.input_indices.append(idx)
        self.num_inputs += 1
        return idx

    # ---- constraints

    def _cid(self, coeff: int) -> int:
        cid = self._coeff_ids.get(coeff)
        if cid is None:
            cid = len(self._palette)
            self._palette.append(coeff)
            self._coeff_ids[coeff] = cid
        return cid

    def enforce(self, a: LC, b: LC, c: LC):
        r = self.n_constraints
        self.n_constraints = r + 1
        for m, l in enumerate((a, b, c)):
            rows, vars_, cids = self._rows[m], self._vars[m], self._cids[m]
            for var, coeff in l.items():
                rows.append(r)
                vars_.append(var)
                cids.append(self._cid(coeff))

    # ---- evaluation

    def value(self, var: int) -> Optional[int]:
        return self.assignment[var]

    def eval_lc(self, l: LC) -> Optional[int]:
        acc = 0
        for var, coeff in l.items():
            v = self.assignment[var]
            if v is None:
                return None
            acc += v * coeff
        return acc % P

    def is_satisfied(self) -> Optional[int]:
        """Index of the first violated constraint, or None if all hold.
        Host-side check over the COO arrays (test/debug path)."""
        if any(v is None for v in self.assignment):
            raise SynthesisError("unassigned variable")
        evals = []
        for m in range(3):
            acc = [0] * self.n_constraints
            rows, vars_, cids = self._rows[m], self._vars[m], self._cids[m]
            pal, assign = self._palette, self.assignment
            for t in range(len(rows)):
                acc[rows[t]] += assign[vars_[t]] * pal[cids[t]]
            evals.append(acc)
        for i in range(self.n_constraints):
            if evals[0][i] * evals[1][i] % P != evals[2][i] % P:
                return i
        return None

    # ---- canonical matrices (input-major reindexing)

    def _remap(self) -> np.ndarray:
        """old var index -> input-major new index."""
        n = len(self.assignment)
        remap = np.full(n, -1, dtype=np.int32)
        inputs = np.asarray(self.input_indices, dtype=np.int64)
        remap[inputs] = np.arange(len(inputs), dtype=np.int32)
        aux_mask = remap < 0
        remap[aux_mask] = len(inputs) + np.arange(
            int(aux_mask.sum()), dtype=np.int32
        )
        return remap

    def compiled(self) -> CompiledR1CS:
        remap = self._remap()
        rows = tuple(np.frombuffer(r, dtype=np.int32).copy() for r in self._rows)
        vars_ = tuple(
            remap[np.frombuffer(v, dtype=np.int32)] for v in self._vars
        )
        cids = tuple(np.frombuffer(c, dtype=np.int32).copy() for c in self._cids)
        return CompiledR1CS(
            num_vars=len(self.assignment),
            num_inputs=self.num_inputs,
            n_constraints=self.n_constraints,
            rows=rows,
            vars=vars_,
            cids=cids,
            palette=list(self._palette),
        )

    def full_assignment(self) -> List[int]:
        """Assignment in input-major order (proving mode only).

        The permutation applies through an object-array fancy-index
        (C-speed) instead of a Python loop: at 13M mainnet-circuit vars
        the loop alone was ~12 s of the witness-encode wall."""
        if any(v is None for v in self.assignment):
            raise SynthesisError("constraint system not in proving mode")
        import numpy as np

        remap = np.asarray(self._remap(), dtype=np.int64)
        inv = np.empty_like(remap)  # inv[new] = old
        inv[remap] = np.arange(remap.shape[0], dtype=np.int64)
        return np.asarray(self.assignment, dtype=object)[inv].tolist()
