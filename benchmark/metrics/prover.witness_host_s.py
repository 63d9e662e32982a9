"""prover.witness_host_s: seconds per proof of the witness encode's host
half, the program's spans `witness.assignment` (the full assignment) and
`witness.limbs` (reduced mod r and cut into limbs) inside `create_proof`,
the median over the process's proofs."""

from harness.calls import per_proof, spans_s


def read(layer):
    return per_proof(lambda c: spans_s(c, "witness.assignment",
                                       "witness.limbs"))
