"""prover.eval_h_s: seconds per proof of the row evaluation and h(x)
(`row_eval` + `h_ntt` of `create_proof`'s stage seconds), the mean over the
window's proofs."""

from statistics import mean


def read(layer):
    stages = layer.get("stages")
    return (mean(s["row_eval"] + s["h_ntt"] for s in stages)
            if stages else None)
