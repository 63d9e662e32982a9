"""device.idle_share.block: the share of one traced block's wall time in
which no operation ran on the device (one minus the union of the device
intervals of the profiler's trace over the block), in %."""


def read(layer):
    return layer.get("idle_pct")
