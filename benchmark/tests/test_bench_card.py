"""The benchmark on the card: one traced run of each cell of
`BENCHMARK.json` with a short window comes out correct, reports every
per-layer metric of the cell, and keeps the kernels' share of their bound
under 105 %.  Skips without a CUDA device (the `card` fixture).

    python -m pytest benchmark/tests/test_bench_card.py -q   # on the card
"""

import json
import time
from pathlib import Path

import pytest

from harness import main, spec
from harness.outcome import Run

ROOT = Path(__file__).resolve().parent.parent.parent
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(card, workload):
    import torch

    cell = spec.Cell(ROOT, workload)
    out = main.execute(Run(cell, 2 ** 31 + 101, 1.0, True, card),
                       time.perf_counter(), torch.cuda.get_device_name(0))
    assert out["correct"] is True
    assert set(out["metrics"]) == {m["name"] for m in cell.per_layer}
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    roofline = out["metrics"].get("kernels_roofline")
    assert roofline is None or roofline["value"] <= 105.0
