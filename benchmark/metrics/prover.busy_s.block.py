"""prover.busy_s.block: seconds per block in the three works'
`create_proof` on the card, each closed by a synchronise, by the
benchmark's own spans around those calls, the mean over the window's
blocks."""


def read(layer):
    return layer.get("per_block", {}).get("prover")
