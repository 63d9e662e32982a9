"""prover.dedup_wait_s: seconds per proof that the prover waits past h(x)
for the dedup plans built on the host (`dedup_plans` of `create_proof`'s
stage seconds), the mean over the window's proofs."""

from statistics import mean


def read(layer):
    stages = layer.get("stages")
    return mean(s["dedup_plans"] for s in stages) if stages else None
