"""msm.busy_s: seconds per proof of the five MSMs (the `msm_*` stages of
`create_proof`'s stage seconds, uploads excluded), the mean over the
window's proofs."""

from statistics import mean


def read(layer):
    stages = layer.get("stages")
    if not stages:
        return None
    return mean(sum(v for k, v in s.items() if k.startswith("msm_"))
                for s in stages)
