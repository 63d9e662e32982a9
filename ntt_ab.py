#!/usr/bin/env python3
"""The NTT's two single-card algorithms against each other at the mainnet
proof's domain, on one NVIDIA GPU (`bazuka_tpu_torch/ops/ntt.py`): the
four-step (from 2^_FOURSTEP_MIN_LOG_N; rows through K1's stage entry over
rows) and the radix-2 stage entry over the whole array, which above
2^_TABLE_CACHE_MAX_LOG_N rebuilds its tables on every call.

    python3 ntt_ab.py              # at 2^24
    python3 ntt_ab.py --log-n 23

Prints the card's name and power limit (nvidia-smi), then JSON lines:
  build    seconds to build the kernels
  ntt      per direction: whether both algorithms give the same limbs, the
           seconds of a first (cold) and a second (warm) call of each, the
           card synchronised, and the device memory each allocated above
           its input
  tables   seconds to build one direction's stage twiddles and coset
           scales (the per-call rebuild) at 2^22 (if log_n is larger) and
           at 2^log_n
  h_phase  `prove.compute_h_mont` (7 NTTs, parked polynomials in big mode)
           on random evaluations at 2^log_n: seconds of a first and a
           second call, equal limbs, its peak above its inputs
Exits with code 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from bazuka_tpu_torch.fields.limbs import fr_field
from bazuka_tpu_torch.groth16 import prove
from bazuka_tpu_torch.ops import _cuda
from bazuka_tpu_torch.ops import ntt as tn
from chip_smoke import nvidia_smi_line, random_field_limbs


def emit(obj):
    print(json.dumps(obj), flush=True)


def timed(run):
    """(result, seconds, bytes allocated above the start), synchronised."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() - base)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-n", type=int, default=24)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ntt_ab: no CUDA device", file=sys.stderr)
        return 2
    print(nvidia_smi_line(), flush=True)
    t0 = time.perf_counter()
    _cuda.build_all()
    emit({"build_s": time.perf_counter() - t0})
    dev = torch.device("cuda")
    F = fr_field()
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    n = 1 << args.log_n
    x = random_field_limbs(F, n, gen, dev)
    fourstep_min = tn._FOURSTEP_MIN_LOG_N
    for inverse in (False, True):
        row = {"ntt": args.log_n, "inverse": inverse}
        outs = {}
        for name, min_log_n in (("fourstep", min(fourstep_min, args.log_n)),
                                ("radix2", 64)):
            tn._FOURSTEP_MIN_LOG_N = min_log_n
            tn.clear_table_cache()
            y, cold, peak = timed(lambda: tn.ntt_mont(x, inverse))
            _, warm, _ = timed(lambda: tn.ntt_mont(x, inverse))
            outs[name] = y
            row.update({f"{name}_s": [cold, warm], f"{name}_peak": peak})
        tn._FOURSTEP_MIN_LOG_N = fourstep_min
        row["equal"] = bool(torch.equal(outs["fourstep"], outs["radix2"]))
        emit(row)
        del outs, y
    for log_n in sorted({min(22, args.log_n), args.log_n}):
        def tables():
            tn._build_stage_twiddles(log_n, False, dev.type)
            tn._build_coset_scale(log_n, False, dev.type)
        emit({"tables": log_n, "s": timed(tables)[1]})
    del x
    torch.cuda.empty_cache()
    evs = [random_field_limbs(F, n, gen, dev) for _ in range(3)]
    h1, cold, peak = timed(lambda: prove.compute_h_mont(list(evs), n))
    h2, warm, _ = timed(lambda: prove.compute_h_mont(list(evs), n))
    emit({"h_phase": args.log_n, "s": [cold, warm], "peak": peak,
          "equal": bool(torch.equal(h1, h2))})
    print(nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
