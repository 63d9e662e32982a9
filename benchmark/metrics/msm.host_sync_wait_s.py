"""msm.host_sync_wait_s: seconds per proof that the MSM drains' host
reads of their data-dependent scan wait for the card (the sum of the
program's `msm.sync` spans), the median over the process's proofs."""

from harness.calls import per_proof, spans_s


def read(layer):
    return per_proof(lambda c: spans_s(c, "msm.sync"))
