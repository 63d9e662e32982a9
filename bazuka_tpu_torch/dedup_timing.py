"""Time the dedup planner's two ways of grouping a witness-like scalar
vector, and how much each lets another thread run meanwhile.

    python3 -m bazuka_tpu_torch.dedup_timing --log-n 20

The vector has the MPN witness's shape: about 40 % zeros, 30 % ones, a few
values repeated near the presum threshold, the rest random.  For each of
`_heavy_groups_exact` (np.unique over 64-byte void rows) and
`_heavy_groups_hashed` (a sort of one 64-bit hash per row) it prints one
JSON line: the seconds of a plain call, and the seconds of a call on a
worker thread with the iterations a busy loop on the main thread made
meanwhile, per second (what the prover's launch loop would get).  The two
results must be equal.  Host only; needs no card.
"""

from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np

from .ops import msm_lm


def witness_like(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 1 << 16, (n, 16), dtype=np.uint32)
    rows[rng.random(n) < 0.4] = 0
    ones = rng.random(n) < 0.3
    rows[ones] = 0
    rows[ones, 0] = 1
    for k in range(20):
        rows[rng.integers(0, n, k + 1)] = rng.integers(
            0, 1 << 16, 16, dtype=np.uint32)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-n", type=int, default=20)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    rows = witness_like(1 << args.log_n, args.seed)
    results = []
    for fn in (msm_lm._heavy_groups_exact, msm_lm._heavy_groups_hashed):
        t0 = time.perf_counter()
        res = fn(rows, 8)
        alone = time.perf_counter() - t0
        worker = threading.Thread(target=fn, args=(rows, 8))
        t0 = time.perf_counter()
        worker.start()
        spins = 0
        while worker.is_alive():
            spins += 1
        threaded = time.perf_counter() - t0
        results.append(res)
        print(json.dumps({"grouping": fn.__name__, "rows": rows.shape[0],
                          "seconds": alone, "threaded_seconds": threaded,
                          "main_thread_spins_per_s": spins / threaded,
                          "heavy_values": int(res[2].shape[0])}))
    if not all(np.array_equal(a, b) for a, b in zip(*results)):
        raise SystemExit("the two groupings disagree")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
