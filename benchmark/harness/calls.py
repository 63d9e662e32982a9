"""The program's own call records, as the per-layer metrics of its spans
and counters read them: `bazuka_tpu_torch.utils.spans.snapshot()` in this
process, after the run.  A program without that recorder has none: each
such metric reads None and is left out of the line.  With the recorder, a
process that recorded no call of a name reads 0 there, as nothing of it
ran; a run of the benchmark records every call these metrics read."""

from __future__ import annotations

from statistics import median


def calls(name: str):
    """The process's recorded calls of `name`, oldest first; None without
    the recorder."""
    try:
        from bazuka_tpu_torch.utils import spans
    except ImportError:
        return None
    return [c for c in spans.snapshot() if c["name"] == name]


def per_proof(value):
    """The median of value(call) over the process's `create_proof` calls
    (the warm proof's first-use costs fall outside it): 0 without one,
    None without the recorder."""
    proofs = calls("create_proof")
    if proofs is None:
        return None
    return median(value(c) for c in proofs) if proofs else 0


def total(name: str, value):
    """The sum of value(call) over the process's calls of `name` (0
    without one), None without the recorder."""
    got = calls(name)
    return None if got is None else sum(value(c) for c in got)


def spans_s(call: dict, *names) -> float:
    """The seconds of a call's spans of these names, together."""
    return sum(call["spans"].get(n, 0.0) for n in names)
