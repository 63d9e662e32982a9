"""Spans and counters of the prover, keygen and synthesis, always on.

A root call (`call`: `create_proof`, `generate_parameters`,
`synthesize_circuit`) collects, by name, the seconds of the spans that end
inside it (`span`, `timed`, and the consecutive stages of `Stages`) and its
counters (`count`).  A span also counts once under its own name, so
`counts[name]` says how often it ran.  The process keeps its last
MAX_CALLS finished calls; `snapshot()` returns copies of them and is the
one way to read the recorder: an operator calls it in-process.

The recorder reads the host's clock and nothing else: a span is two
`time.perf_counter_ns` reads and one list append, a counter one append,
both summed by name when their call ends, and nothing here waits for the
device.  If a torch profiler records when a call begins (torch's own
check, `torch.autograd._profiler_enabled`), each of the call's spans,
stages and the call itself is also a range of the profiler's named
"bz.<name>", so the trace carries the program's spans beside the device's
kernels on its clock.  The profiler follows the thread that started it: a
span on another thread has no range there.

The call a span lands in is the context variable of the thread that opens
it: work run on another thread lands in the submitter's call when it runs
in a copy of the submitter's context (`contextvars.copy_context().run`)
and ends before the call does.  Spans and counters outside any call are
dropped.
"""

from __future__ import annotations

import contextvars
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, Optional

import torch

MAX_CALLS = 256

_lock = threading.Lock()
_calls: deque = deque(maxlen=MAX_CALLS)
_current: contextvars.ContextVar = contextvars.ContextVar(
    "bazuka_spans_call", default=None)
_now = time.perf_counter_ns


class _Call:
    """One root call: its name, start and end (perf_counter_ns), whether a
    profiler recorded at its start, the `Stages` it runs, and its events
    as (name, ns, n) in the order they ended: a span's (ns, 1), a
    counter's (None, n); summed into `spans` (name -> ns) and `counts`
    (name -> n) when the call ends."""

    __slots__ = ("name", "start_ns", "end_ns", "profiling", "stages",
                 "events", "spans", "counts")

    def __init__(self, name: str):
        self.name = name
        self.profiling = torch.autograd._profiler_enabled()
        self.stages = None
        self.events = []  # appended from any thread: atomic, no lock
        self.spans = {}
        self.counts = {}
        self.end_ns = None
        self.start_ns = _now()

    def fold(self):
        spans, counts = self.spans, self.counts
        for name, ns, n in self.events:
            if ns is not None:
                spans[name] = spans.get(name, 0) + ns
            counts[name] = counts.get(name, 0) + n
        self.events = []


def _open_range(call: Optional[_Call], name: str):
    """The profiler's range "bz.<name>", entered, if `call` began while a
    profiler recorded; else None.  The range is an operator-scope one
    (`_RecordFunctionFast`), not `record_function`'s user scope: the
    profiler copies a user-scope range onto the device's timeline, where
    a reader of the trace's device events would count it as device
    work."""
    if call is None or not call.profiling:
        return None
    rng = torch._C._profiler._RecordFunctionFast("bz." + name)
    rng.__enter__()
    return rng


def _close_range(rng):
    if rng is not None:
        rng.__exit__(None, None, None)


class span:
    """`with span(name):` times its block into the current call."""

    __slots__ = ("name", "call", "rng", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.call = call = _current.get()
        # the profiling test inlined: a span without a range makes no call
        self.rng = (_open_range(call, self.name)
                    if call is not None and call.profiling else None)
        self.t0 = _now()
        return self

    def __exit__(self, *exc):
        ns = _now() - self.t0
        if self.rng is not None:
            self.rng.__exit__(None, None, None)
        if self.call is not None:
            self.call.events.append((self.name, ns, 1))
        return False


def timed(name: str, fn: Callable, *args):
    """fn(*args), timed as the span `name`: `span`'s work without its
    object, for spans that run hundreds of times a call."""
    call = _current.get()
    rng = (_open_range(call, name)
           if call is not None and call.profiling else None)
    t0 = _now()
    try:
        return fn(*args)
    finally:
        ns = _now() - t0
        if rng is not None:
            rng.__exit__(None, None, None)
        if call is not None:
            call.events.append((name, ns, 1))


def count(name: str, n: int = 1):
    """Add n to the current call's counter `name`."""
    call = _current.get()
    if call is not None:
        call.events.append((name, None, n))


@contextmanager
def call(name: str):
    """A root call (a context manager, or a decorator of the function it
    times): the spans and counters inside it land in its record, which is
    kept once it ends.  A call inside another is a root of its own."""
    rec = _Call(name)
    token = _current.set(rec)
    rng = _open_range(rec, name)
    try:
        yield rec
    finally:
        rec.end_ns = _now()
        if rec.stages is not None:  # a stage left open by an exception
            _close_range(rec.stages._rng)
            rec.stages._rng = None
        _close_range(rng)
        _current.reset(token)
        rec.fold()
        with _lock:
            _calls.append(rec)


class Stages:
    """The consecutive stages of the current call, each a span:
    `next(name)` ends the running stage and starts the one named.
    `seconds` holds each ended stage's seconds in the order they ran.
    `sync`, if given, runs before each boundary: a caller that asked for
    stage timings synchronises the device there; the recorder itself never
    does."""

    def __init__(self, first: str, sync: Optional[Callable] = None):
        self.seconds = {}
        self._sync = sync
        self._call = _current.get()
        if self._call is not None:
            self._call.stages = self
        self._name = first
        self._rng = _open_range(self._call, first)
        self._t = _now()

    def next(self, name: Optional[str]):
        """End the running stage and start `name` (None: start none)."""
        if self._sync is not None:
            self._sync()
        now = _now()
        _close_range(self._rng)
        self._end(self._name, now - self._t)
        self._name, self._t = name, now
        self._rng = None if name is None else _open_range(self._call, name)

    def end(self):
        """End the last stage."""
        self.next(None)

    def _end(self, name: str, ns: int):
        self.seconds[name] = ns / 1e9
        if self._call is not None:
            self._call.events.append((name, ns, 1))


def snapshot() -> list:
    """Copies of the kept calls, oldest first: each a dict of "name",
    "start_ns", "end_ns" (perf_counter_ns), "seconds", "spans" ({name:
    seconds}) and "counts" ({name: n})."""
    with _lock:
        return [{"name": c.name, "start_ns": c.start_ns,
                 "end_ns": c.end_ns,
                 "seconds": (c.end_ns - c.start_ns) / 1e9,
                 "spans": {k: ns / 1e9 for k, ns in c.spans.items()},
                 "counts": dict(c.counts)} for c in _calls]
