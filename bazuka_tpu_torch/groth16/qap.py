"""R1CS -> QAP reduction over the 2^k evaluation domain (a copy of
`bazuka_tpu/groth16/qap.py`).

Domain layout (bellman-equivalent so mainnet-compatible keys remain
possible, SURVEY.md §7 hard-part #3): one row per constraint, then one
appended row per public input enforcing (input_i)·0 = 0 — this makes the
input polynomials linearly independent, a Groth16 soundness requirement.
Domain size d = next power of two ≥ (constraints + inputs).

Lagrange evaluation at a secret point tau (keygen) uses the barycentric
form L_j(tau) = w^j (tau^d - 1) / (d (tau - w^j)) with a Montgomery-trick
batch inversion — O(d) field ops host-side.
"""

from __future__ import annotations

from typing import List

from ..fields.host import FR_MODULUS
from ..ops.ntt import root_of_unity

P = FR_MODULUS


def domain_size(n_constraints: int, n_inputs: int) -> int:
    need = n_constraints + n_inputs
    d = 1
    while d < need:
        d *= 2
    return d


def batch_inverse(vals: List[int]) -> List[int]:
    """Montgomery trick: n inversions for 3n muls + 1 inversion."""
    n = len(vals)
    prefix = [1] * (n + 1)
    for i, v in enumerate(vals):
        if v % P == 0:
            raise ZeroDivisionError("batch_inverse of zero")
        prefix[i + 1] = prefix[i] * v % P
    inv_all = pow(prefix[n], -1, P)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % P
        inv_all = inv_all * vals[i] % P
    return out


def lagrange_at(tau: int, d: int) -> List[int]:
    """[L_j(tau) for j in 0..d-1] over the size-d power-of-two domain."""
    log_d = d.bit_length() - 1
    w = root_of_unity(log_d)
    z = (pow(tau, d, P) - 1) % P
    pows = [1] * d
    for j in range(1, d):
        pows[j] = pows[j - 1] * w % P
    denoms = [(d * (tau - pows[j])) % P for j in range(d)]
    if any(v == 0 for v in denoms):
        raise ZeroDivisionError("tau in evaluation domain")
    inv = batch_inverse(denoms)
    return [pows[j] * z % P * inv[j] % P for j in range(d)]
