"""The benchmark's data, found by name: `BENCHMARK.json` at the checkout's
root, a configuration's file as its entry gives it, a traffic mix in
`benchmark/traffic/<traffic>.json`, a per-layer metric's reader in
`benchmark/metrics/<metric>.py` and a driver in
`benchmark/harness/drivers/<driver>.py`.  A later cell, mix or metric is
added by adding files and entries: nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent


class Cell:
    """One workload of `BENCHMARK.json` with everything it names."""

    def __init__(self, root: Path, workload: str):
        spec = json.loads((root / "BENCHMARK.json").read_text())
        by_name = {w["name"]: w for w in spec["workloads"]}
        if workload not in by_name:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = by_name[workload]
        self.name = workload
        entry = next(c for c in spec["configs"]
                     if c["name"] == self.workload["config"])
        self.config = json.loads((root / entry["file"]).read_text())
        self.traffic = json.loads(
            (BENCH / "traffic" / f"{self.workload['traffic']}.json")
            .read_text())
        self.chips = self.workload["chips"]
        self.end_to_end = [m for m in spec["end_to_end"] if self.takes(m)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"] if self.takes(m)
                          and m["moves"] in reported]

    def takes(self, metric: dict) -> bool:
        return self.name in metric.get("workloads", [self.name])

    def driver(self):
        return importlib.import_module(
            f"harness.drivers.{self.traffic['driver']}")


def reader(metric: str):
    """The `read(layer)` function of a per-layer metric's file."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
