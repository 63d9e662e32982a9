"""msm.host_syncs: the MSM drains' host reads of their data-dependent
scan per proof (the number of the program's `msm.sync` spans), the
median over the process's proofs."""

from harness.calls import per_proof


def read(layer):
    return per_proof(lambda c: c["counts"].get("msm.sync", 0))
