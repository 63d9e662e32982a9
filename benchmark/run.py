#!/usr/bin/env python3
"""Run one cell of the benchmark of `bazuka_tpu_torch`, the PyTorch and CUDA
port, from the root of a checkout:

    python3 benchmark/run.py --workload mainnet.withdraw.full --seed 7 \
        --seconds 45 --trace 0

See benchmark/README.md and benchmark/harness/main.py.
"""

import time

T_START = time.perf_counter()  # the process's start, for setup_s

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the program's kernel caches live inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(var, str(ROOT / ".bench_cache" / sub))
sys.path[:0] = [str(HERE), str(ROOT)]

from harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], ROOT, T_START))
