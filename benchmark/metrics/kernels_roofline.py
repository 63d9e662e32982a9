"""kernels_roofline: over one traced proof, the sum of every K1-K5
launch's bound (the larger of its bytes over 3.35 TB/s and its IMADs over
16.7e12/s, counted by `harness.counting` from the launch sizes, the curve
adds at their active lanes) over those kernels' device time in the
profiler's trace, in %."""


def read(layer):
    return layer.get("roofline_pct")
