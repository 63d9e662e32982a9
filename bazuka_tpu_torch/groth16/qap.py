"""R1CS -> QAP domain size.

The part of `bazuka_tpu/groth16/qap.py` the prover needs, copied.

Domain layout (bellman-equivalent so mainnet-compatible keys remain
possible, SURVEY.md §7 hard-part #3): one row per constraint, then one
appended row per public input enforcing (input_i)·0 = 0 — this makes the
input polynomials linearly independent, a Groth16 soundness requirement.
Domain size d = next power of two ≥ (constraints + inputs).
"""

from __future__ import annotations


def domain_size(n_constraints: int, n_inputs: int) -> int:
    need = n_constraints + n_inputs
    d = 1
    while d < need:
        d *= 2
    return d
