"""One call under torch.profiler, and what the benchmark reads from its
trace: the device's busy time (the union of its operations' intervals),
device time by operation, and the idle gaps by what the host was doing
(the benchmark's own spans, or the program's stage seconds, laid on the
same clock).

The trace's raw events are read (`kineto_results.events()`), not the
parsed event tree, which costs about 0.3 ms per event to build.  A
record_function mark at the start of the call ties the trace's clock to
`time.perf_counter`.
"""

from __future__ import annotations

import time

import torch

MARK = "benchmark.window"
TOP = 10  # entries of each breakdown list
NAME_CHARS = 120

# the device kernels of K1-K5 (the proof's own kernels; K6/K7, keygen's
# `proj_add_kernel`, are not among them)
PROOF_KERNELS = ("::madd_select_kernel<", "::proj_add_select_kernel<",
                 "mont_mul_kernel<", "mont_inv_fp_kernel",
                 "ntt_low_kernel", "ntt_stage_kernel")


class Trace:
    """The device events of one profiled call, in µs since its start."""

    def __init__(self, events, window_s: float, t0: float):
        self.events = events  # [(name, start µs, length µs)]
        self.window_s = window_s
        self.t0 = t0  # perf_counter at the call's start

    def busy_s(self) -> float:
        return union_us((s, s + d) for _, s, d in self.events) / 1e6

    def kernel_s(self, keys) -> float:
        """Device time of the events whose name holds one of `keys`."""
        return sum(d for name, _, d in self.events
                   if any(k in name for k in keys)) / 1e6

    def device_ops(self) -> list:
        by = {}
        for name, _, d in self.events:
            name = name[:NAME_CHARS]
            by[name] = by.get(name, 0.0) + d / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:TOP]

    def idle_gaps(self, spans) -> list:
        """Idle time of the device by the span (name, start, end in
        perf_counter seconds) the host was in: each gap's seconds go to
        the spans it overlaps, the rest to "other"."""
        edges = merged((s, s + d) for _, s, d in self.events)
        end_us = self.window_s * 1e6
        gaps, last = [], 0.0
        for a, b in edges + [(end_us, end_us)]:
            if a > last:
                gaps.append((self.t0 + last / 1e6, self.t0 + a / 1e6))
            last = max(last, b)
        by = {}
        for a, b in gaps:
            rest = b - a
            for name, s, e in spans:
                part = min(b, e) - max(a, s)
                if part > 0:
                    by[name] = by.get(name, 0.0) + part
                    rest -= part
            if rest > 0:
                by["other"] = by.get("other", 0.0) + rest
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:TOP]


def merged(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def union_us(intervals) -> float:
    return sum(b - a for a, b in merged(intervals))


def profiled(fn):
    """(fn(), Trace of it): fn runs under the profiler, closed by a
    synchronise."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(MARK):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
    raw = list(prof.profiler.kineto_results.events())
    start_ns = next(e.start_ns() for e in raw if e.name() == MARK
                    and e.device_type() == DeviceType.CPU)
    # the mark's own range on the device's timeline is no operation
    events = [(e.name(), (e.start_ns() - start_ns) / 1e3,
               e.duration_ns() / 1e3)
              for e in raw if e.device_type() == DeviceType.CUDA
              and e.name() != MARK]
    return out, Trace(events, t1 - t0, t0)
