"""device.idle_share.prove: the share of one traced proof's wall time in
which no operation ran on the device (one minus the union of the device
intervals of the profiler's trace over the call), in %."""


def read(layer):
    return layer.get("idle_pct")
