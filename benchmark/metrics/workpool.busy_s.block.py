"""workpool.busy_s.block: seconds per block in the work pool:
`prepare_works` and the three `MpnWorkPool.prove` calls (each one host
pairing check), by the benchmark's own spans around those calls, the
mean over the window's blocks."""


def read(layer):
    return layer.get("per_block", {}).get("workpool")
