"""synthesis.busy_s.block: seconds per block in the three works' circuits
built and synthesised (`synthesize_circuit`), by the benchmark's own
spans around those calls, the mean over the window's blocks."""


def read(layer):
    return layer.get("per_block", {}).get("synthesis")
