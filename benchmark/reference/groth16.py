"""The plain reference of a Groth16 proof over BLS12-381: the proof that a
key of known toxic waste must give, worked out on the host in Python
integers (numpy object arrays), imports nothing of the program.

The key is the reference `--dev` keygen's (bazuka's in-process setup,
bellman's QAP layout), deterministic from its seed:

  * toxic waste (τ, α, β, γ, δ): the first five nonzero values mod r of
    SHA3-256(seed ‖ b"toxic" ‖ counter as 8 little-endian bytes),
    counter = 0, 1, ...;
  * the domain: d = the least power of two ≥ constraints + public
    inputs (ONE counted), ω = 7^((r − 1) / d); row j < constraints is
    constraint j, row constraints + i is (input i)·0 = 0, the rest are
    empty; L_j(τ) = ω^j (τ^d − 1) / (d (τ − ω^j)).

With a(τ) = Σ_j L_j(τ) (A_j · z), and b, c alike, and the aux part of
each (the variables past the public inputs), a proof at (r, s) is

    A = (α + a(τ) + rδ)·G1,   B = (β + b(τ) + sδ)·G2,
    C = ((β a_aux + α b_aux + c_aux + a(τ) b(τ) − c(τ)) / δ
         + s (α + a(τ) + rδ) + r (β + b(τ) + sδ) − rsδ)·G1,

since h(τ) Z(τ) = a(τ) b(τ) − c(τ) whenever z satisfies every row.  A
witness that does not satisfy its circuit has no such proof: the prover's
h(x) is then not that quotient, and its C differs.

The circuit comes as COO arrays: for each of A, B, C, parallel arrays of
term rows, variables (ONE = 0, public inputs 1..n_inputs − 1, then aux)
and palette ids, with the palette's coefficients; z is the full
assignment in that variable order.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .curve import R, g1_mul, g2_mul

GENERATOR = 7  # the multiplicative generator of Fr that fixes ω
TERM_CHUNK = 1 << 21  # terms per vectorised pass (bounds the host memory)


def toxic(seed: bytes):
    """(τ, α, β, γ, δ) of the key of `seed`."""
    out, counter = [], 0
    while len(out) < 5:
        h = hashlib.sha3_256(seed + b"toxic" + counter.to_bytes(8, "little"))
        v = int.from_bytes(h.digest(), "little") % R
        if v:
            out.append(v)
        counter += 1
    return tuple(out)


def domain_size(n_constraints: int, n_inputs: int) -> int:
    d = 1
    while d < n_constraints + n_inputs:
        d *= 2
    return d


def _obj(values) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


def powers(w: int, n: int) -> np.ndarray:
    """[w^0, ..., w^(n-1)] mod r, vectorised in blocks."""
    block = 1 << 11
    small = [1] * block
    for i in range(1, block):
        small[i] = small[i - 1] * w % R
    wb = small[-1] * w % R
    n_big = -(-n // block)
    big = [1] * n_big
    for i in range(1, n_big):
        big[i] = big[i - 1] * wb % R
    grid = (_obj(big)[:, None] * _obj(small)[None, :]) % R
    return grid.reshape(-1)[:n]


def batch_inverse(v: np.ndarray) -> np.ndarray:
    """Elementwise inverses mod r of a nonzero object array: a product
    tree up, one inversion, the tree down."""
    levels = []
    x = v
    while len(x) > 1:
        if len(x) % 2:
            x = np.concatenate([x, _obj([1])])
        levels.append(x)
        x = (x[0::2] * x[1::2]) % R
    inv = _obj([pow(int(x[0]), -1, R)])
    for x in reversed(levels):
        inv = inv[:len(x) // 2]
        out = np.empty(len(x), dtype=object)
        out[0::2] = (inv * x[1::2]) % R
        out[1::2] = (inv * x[0::2]) % R
        inv = out
    return inv[:len(v)]


def lagrange(tau: int, d: int, n_rows: int) -> np.ndarray:
    """[L_j(τ) for j < n_rows] over the size-d domain."""
    w = pow(GENERATOR, (R - 1) // d, R)
    z = (pow(tau, d, R) - 1) % R
    pw = powers(w, n_rows)
    den = (d * (tau - pw)) % R
    if not all(den):
        raise ZeroDivisionError("τ lies in the domain")
    return (pw * z % R) * batch_inverse(den) % R


def lagrange_rows(circuit: dict, tau: int) -> np.ndarray:
    """L_j(τ) over the circuit's rows (its constraints, then its inputs'),
    shared by every assignment of the circuit."""
    n, ni = circuit["n_constraints"], circuit["n_inputs"]
    return lagrange(tau, domain_size(n, ni), n + ni)


def qap_at(circuit: dict, z, L: np.ndarray) -> dict:
    """a(τ), b(τ), c(τ) and their aux parts for assignment z, from the
    circuit's `lagrange_rows` at τ."""
    n, ni = circuit["n_constraints"], circuit["n_inputs"]
    zo = _obj([v % R for v in z])
    pal = _obj([v % R for v in circuit["palette"]])
    out = {}
    for name, (rows, vars_, cids) in zip("abc", circuit["terms"]):
        total = aux = 0
        for lo in range(0, len(rows), TERM_CHUNK):
            v = vars_[lo:lo + TERM_CHUNK]
            t = (L[rows[lo:lo + TERM_CHUNK]] * pal[cids[lo:lo + TERM_CHUNK]]
                 % R) * zo[v]
            total += int(t.sum())
            aux += int(t[v >= ni].sum())
        if name == "a":  # the input rows: (input i)·0 = 0
            total += int((L[n:n + ni] * zo[:ni]).sum())
        out[name] = total % R
        out[name + "_aux"] = aux % R
    return out


def expected_proof(q: dict, waste, r: int, s: int):
    """(A, B, C) affine, as the key of `waste` proves q's witness at r, s."""
    _, alpha, beta, _, delta = waste
    a_sc = (alpha + q["a"] + r * delta) % R
    b_sc = (beta + q["b"] + s * delta) % R
    lh = (beta * q["a_aux"] + alpha * q["b_aux"] + q["c_aux"]
          + q["a"] * q["b"] - q["c"]) * pow(delta, -1, R)
    c_sc = (lh + s * a_sc + r * b_sc - r * s * delta) % R
    return g1_mul(a_sc), g2_mul(b_sc), g1_mul(c_sc)


def wrong_points(proof, want) -> int:
    """How many of the proof's three points differ from `want`'s."""
    return sum(p != w for p, w in zip(proof, want))
