"""The witness encode: a constraint system's assignment -> the (Np, 16)
uint16 limb rows of its input-major order, zero-padded to the key's length.

One native pass (`csrc/witness.cpp`) reads each value in the constraint
system's own order (`cs.assignment`), reduces it mod r only when it is not
already below r, and writes its 16 limbs at its input-major row
(`ConstraintSystem._remap()`), so the permutation is a scatter inside the
pass.  A `cs` without `assignment` and `_remap` is encoded from
`full_assignment()` in its own order.

The library is built at first use against this interpreter's `Python.h`
and loaded with `ctypes.PyDLL` (`ops/_cxx.py`): the pass walks Python ints,
so it holds the GIL.  Where it cannot be built or loaded, the bytes path
(`fields.limbs.ints_to_array` over `full_assignment()`) does the same work.

Spans: `witness.assignment` (getting the assignment and the remap, or
`full_assignment()`), `witness.limbs` (the pass).  Counters, counted only
when nonzero: `witness.reduced` (values the pass had to reduce),
`witness.fallback` (1 when the bytes path ran).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from ..fields.host import FR_MODULUS
from ..fields.limbs import ints_to_array
from ..ops import _cxx
from ..ops._cuda import CSRC
from ..utils import spans
from ..utils.logging import logger
from .r1cs import SynthesisError

P = FR_MODULUS
_P_LE = P.to_bytes(32, "little")

SOURCE = CSRC / "witness.cpp"

_NOT_PROVING = -2  # the pass's code for a None value


@functools.cache
def load_encoder():
    """The native pass (a ctypes function), built at first use; None where
    it cannot be built or loaded (the reason goes to the port's log)."""
    try:
        fn = _cxx.load(SOURCE, python=True).bz_encode_assignment
    except OSError as e:
        logger.warning("witness encoder unavailable, bytes path: %s", e)
        return None
    fn.argtypes = [ctypes.py_object, ctypes.c_void_p, ctypes.py_object,
                   ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.POINTER(ctypes.c_int64)]
    fn.restype = ctypes.c_int64
    return fn


def _values(cs):
    """(values, int32 input-major rows or None for their own order)."""
    if hasattr(cs, "assignment") and hasattr(cs, "_remap"):
        return cs.assignment, np.ascontiguousarray(cs._remap(), np.int32)
    return cs.full_assignment(), None


def encode_assignment(cs, num_vars: int, n_rows: int) -> np.ndarray:
    """`cs`'s assignment -> (n_rows, 16) uint16 limb rows in input-major
    order, each value mod r, rows from num_vars zero.  Raises
    SynthesisError when `cs` is not in proving mode or holds another number
    of values than num_vars, TypeError for a value that is not an int."""
    fn = load_encoder()
    if fn is None:
        spans.count("witness.fallback")
        with spans.span("witness.assignment"):
            vals = cs.full_assignment()
        if len(vals) != num_vars:
            raise SynthesisError("assignment/circuit shape mismatch")
        with spans.span("witness.limbs"):
            rows = np.zeros((n_rows, 16), np.uint16)
            rows[:num_vars] = ints_to_array([v % P for v in vals], 16)
        return rows
    with spans.span("witness.assignment"):
        vals, remap = _values(cs)
    if len(vals) != num_vars or (remap is not None
                                 and remap.shape[0] != num_vars):
        raise SynthesisError("assignment/circuit shape mismatch")
    with spans.span("witness.limbs"):
        rows = np.zeros((n_rows, 16), np.uint16)
        n_reduced = ctypes.c_int64(0)
        rc = fn(vals, None if remap is None else remap.ctypes.data, P,
                _P_LE, rows.ctypes.data, n_rows, ctypes.byref(n_reduced))
    if rc == _NOT_PROVING:
        raise SynthesisError("constraint system not in proving mode")
    if n_reduced.value:
        spans.count("witness.reduced", n_reduced.value)
    return rows
