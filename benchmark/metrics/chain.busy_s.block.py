"""chain.busy_s.block: seconds per block in the chain: `ready` +
`draft_block`, and `apply_block`, by the benchmark's own spans around
those calls, the mean over the window's blocks."""


def read(layer):
    return layer.get("per_block", {}).get("chain")
