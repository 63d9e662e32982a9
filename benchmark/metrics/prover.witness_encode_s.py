"""prover.witness_encode_s: seconds per proof of `create_proof`'s witness
encode (host ints to limbs, the upload, to_mont), the mean of its
`record["seconds"]["witness_encode"]` over the window's proofs."""

from statistics import mean


def read(layer):
    stages = layer.get("stages")
    return mean(s["witness_encode"] for s in stages) if stages else None
