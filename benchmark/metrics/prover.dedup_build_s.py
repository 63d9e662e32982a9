"""prover.dedup_build_s: seconds per proof that the dedup plans take to
build on their worker thread (the program's span `dedup.build`: the
thread's work, not the prover's wait for it), the median over the
process's proofs."""

from harness.calls import per_proof, spans_s


def read(layer):
    return per_proof(lambda c: spans_s(c, "dedup.build"))
