"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result's line.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

With --trace 0 the result's metrics are the cell's end-to-end metrics, with
--trace 1 its per-layer metrics (read after the window by each metric's
reader) and the device's busy and traced seconds.  The last line of
standard output is the result; the numbers that decide `correct`, each
beside its limit, are the last lines of standard error and the last key
of the result.  Without a CUDA device, or with fewer than the cell asks
for, the run exits with code 2 and prints no result; so it does if a
module of JAX or of the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

from . import spec
from .outcome import Run

# top-level module names that no run may load: JAX and the JAX package
# (compared whole: the port's package name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "bazuka_tpu")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules(modules) -> list:
    """The loaded modules whose top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def result(run: Run, outcome, t_start: float, device_kind: str) -> dict:
    """The result's line of a finished run."""
    cell = run.cell
    metrics = {}
    if run.trace:
        for m in cell.per_layer:
            v = spec.reader(m["name"])(outcome.layer)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(outcome.end_to_end,
                      setup_s=outcome.window_start - t_start)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
              "kind": device_kind, "count": cell.chips,
              "memory_peak_bytes": outcome.memory_peak_bytes}
    out = {"correct": outcome.correct, "attempted": outcome.attempted,
           "failed": outcome.failed, "metrics": metrics, "device": device}
    if run.trace and outcome.trace is not None:
        device["busy_s"] = outcome.trace.busy_s()
        device["window_s"] = outcome.trace.window_s
        out["breakdown"] = {
            "device_ops": outcome.trace.device_ops(),
            "idle_gaps": outcome.trace.idle_gaps(outcome.spans)}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in outcome.checks.items()}
    return out


def execute(run: Run, t_start: float, device_kind: str) -> dict:
    """Set-up, window and check of one run: its result."""
    outcome = run.cell.driver().run(run)
    return result(run, outcome, t_start, device_kind)


def main(argv, root, t_start: float) -> int:
    args = parse(argv)
    cell = spec.Cell(root, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}", file=sys.stderr, flush=True)
    run = Run(cell, args.seed, args.seconds, bool(args.trace),
              torch.device("cuda"))
    out = execute(run, t_start, torch.cuda.get_device_name(0))
    out["card"] = card
    out["checks"] = out.pop("checks")  # the last key
    found = forbidden_modules(sys.modules)
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 2
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
