"""Host-side Poseidon over BLS12-381 Fr — bit-exact vs the reference.

A copy of `bazuka_tpu/zk/poseidon_host.py` with the pure-Python permutation
only (the JAX package may hand its hashes to a C++ engine; the port does
not).  Semantics (reference: src/zk/poseidon/mod.rs:14-84):
  * width t = arity + 1; element 0 is the capacity, zeroed at start
  * every round (full AND partial) first adds t round constants
  * full rounds S-box every element; partial rounds S-box element 0 only
  * S-box is x^5; MDS is a dense t x t multiply
  * rounds: R_F/2 full, R_P partial, R_F/2 full; output is element 1

An LRU cache memoizes repeated hashes (the default-subtree hashes dominate
sparse-tree updates; reference: src/zk/mod.rs:491-511 uses a 64-entry
cache for the same reason).  The parameters are read from
`data/poseidon_params.npz`, a copy of the JAX package's file.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np

from ..fields.host import FR_MODULUS
from ..fields.limbs import array_to_ints

_P = FR_MODULUS
MAX_ARITY = 16

_DATA = os.path.join(os.path.dirname(__file__), "data", "poseidon_params.npz")


@dataclass
class PoseidonParams:
    t: int
    full_rounds: int
    partial_rounds: int
    round_constants: list  # flat, length t*(R_F+R_P), consumed in order
    mds: list  # t x t


@functools.cache
def _load_npz():
    return np.load(_DATA)


@functools.cache
def params_for_width(t: int) -> PoseidonParams:
    if not 2 <= t <= 17:
        raise ValueError(f"unsupported poseidon width {t}")
    z = _load_npz()
    rf = int(z[f"t{t}_rf"])
    rp = int(z[f"t{t}_rp"])
    rc = [int(v) for v in array_to_ints(z[f"t{t}_rc"]).reshape(-1)]
    mds_flat = array_to_ints(z[f"t{t}_mds"]).reshape(t, t)
    mds = [[int(mds_flat[i, j]) for j in range(t)] for i in range(t)]
    return PoseidonParams(t, rf, rp, rc, mds)


def _permute(elements: list, params: PoseidonParams) -> list:
    t = params.t
    rc = params.round_constants
    mds = params.mds
    off = 0
    el = list(elements)

    def add_constants():
        nonlocal off
        for i in range(t):
            el[i] = (el[i] + rc[off]) % _P
            off += 1

    def sbox(x):
        x2 = x * x % _P
        x4 = x2 * x2 % _P
        return x4 * x % _P

    def product_mds():
        nonlocal el
        el = [sum(mds[j][k] * el[k] for k in range(t)) % _P for j in range(t)]

    for _ in range(params.full_rounds // 2):
        add_constants()
        el = [sbox(x) for x in el]
        product_mds()
    for _ in range(params.partial_rounds):
        add_constants()
        el[0] = sbox(el[0])
        product_mds()
    for _ in range(params.full_rounds // 2):
        add_constants()
        el = [sbox(x) for x in el]
        product_mds()
    return el


def poseidon_python(vals) -> int:
    """Poseidon of 1..16 Fr elements, uncached."""
    vals = tuple(int(v) for v in vals)
    params = params_for_width(len(vals) + 1)
    el = [0] + [v % _P for v in vals]
    return _permute(el, params)[1]


@functools.lru_cache(maxsize=4096)
def _poseidon_cached(vals: tuple) -> int:
    return poseidon_python(vals)


def poseidon(vals) -> int:
    """Poseidon hash of 1..16 Fr elements (Python ints)."""
    vals = tuple(int(v) for v in vals)
    if not 1 <= len(vals) <= MAX_ARITY:
        raise ValueError(f"poseidon arity {len(vals)} out of range")
    return _poseidon_cached(vals)


class PoseidonHasher:
    """ZkHasher with Poseidon (reference: src/zk/mod.rs:496-511)."""

    MAX_ARITY = MAX_ARITY

    @staticmethod
    def hash(vals) -> int:
        return poseidon(vals)
