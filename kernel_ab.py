#!/usr/bin/env python3
"""The curve-add kernels (K2-K7) and K1's entries of this tree against the
same kernels of other checkouts of the repository, on one NVIDIA GPU, in
one process.

    python3 kernel_ab.py [LABEL=DIR ...]

Each DIR is the root of another checkout (for example a `git archive` of a
parent commit unpacked under `_scratch/`).  Its libraries are built by its
own `bazuka_tpu_torch/ops/_cuda.py` (every source of its `SOURCES`, into its
own `_build/`; all checkouts' builds run at once), and each kernel is looked
up by the C symbol that this tree's `_cuda.REGISTRY` gives it, in whichever
of that checkout's libraries exports it.  This tree is labelled "tree".
The add-select kernels' lane counts are those of the 2^22 proof: 180,224
(the run-merge scan's R_cap, where K3/K5 run most), 90,112 (the drain's
rounds, the bucket placement and the suffix scans) and 2,056 (the presum).
The full adds' (K6/K7) are keygen's at 2^22: 65,536 (GEN_CHUNK, nearly
every launch), 65,535 and 64,292 (last chunks), 4,096 and 32 (the window
table's widest and narrowest passes), and 50,688, one full wave of 128-lane
blocks at 12 warps per SM on 132 SMs, against which 65,536's 1.29 waves
show what the tail wave costs.  Steps, each printed as JSON lines:
  1. build  per checkout, the ptxas registers, spill stores and shared
            memory of every kernel function in the sources that export the
            compared symbols
  2. sass   SASS instructions of one Montgomery multiply of this tree's
            field code: Fp lazy (csrc/fp_lazy.cuh on csrc/mont_ptx.cuh) and
            Fr as K1 computes it (mont_ptx.cuh, one final subtract):
            cuobjdump of a kernel with two chained multiplies less one with
            one; then per checkout the SASS count of every kernel function
            in its `add_select.cu`, `mont_mul.cu` and, where it has one,
            `curve_add.cu` (the earlier K6/K7), and whether each function of
            its `add_select.cu` has this tree's opcodes
  3. ops    fp_lazy.cuh's mul/add/sub/canon on the card against Python ints,
            on edge and random operands in [0, 2p)
  4. ab     per add-select kernel (K2-K5), lane count and mask (replay:
            about 80 % active and scattered, as chip_smoke.py replays;
            drain: the first half of the lanes off, as the zero digits of a
            window sort to its front; merge: lanes with lane % 8192 < 2048
            active, a quarter of them in contiguous blocks, as the digit-0
            runs at the start of each window's 8,192 run lanes are the only
            ones the run-merge scan still merges after its first step;
            full), every checkout bit for bit against the plain version,
            then timed in two turns, the second in the reverse order; ms is
            the mean of the turns, beside chip_smoke.py's roofline bound;
            then K6 and K7 the same way at keygen's lane counts, every lane
            active (mask "none"), with the replay's p − 1 and alternating
            lanes
  5. k1     K1's entries at the 2^22 proof's sizes, bit for bit against
            their plain versions and timed the same way: the Fr multiply at
            2^22 elements (b per element, and one constant row) and 2^21,
            the Fp multiply at keygen's 2^16-element chunks, the NTT's
            stages at 2^22 and 2^21, the Fp inversion at the presum's one
            element and keygen's 2^16.  A checkout without the stage or the
            inversion entry runs what its prover ran instead, on its own
            multiply: the radix-2 loop (K1 per stage, PyTorch's add, sub
            and stack) and `pow_mont`'s 4-bit chain, one launch a product
Exits 1 if any checkout disagrees, 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from bazuka_tpu_torch.fields.limbs import FP_LIMBS, fp_field, fr_field
from bazuka_tpu_torch.ops import _cuda
from bazuka_tpu_torch.ops import field_kernel as fk
from bazuka_tpu_torch.ops import ntt as ntt_mod

P = fp_field().p
PROBE_BUILD = _cuda.BUILD / "probe"
LANES = (180_224, 90_112, 2_056)
# K6/K7's lane counts: keygen's chunk, its last chunks, the window table's
# widest and narrowest passes, and one full wave of 12-warp 128-lane blocks
FULL_LANES = (65_536, 65_535, 64_292, 50_688, 4_096, 32)
# K1's sizes: (field, elements, rows of b) for the multiply, elements for
# the NTT's stages and for the inversion
K1_MUL = (("Fr", 1 << 22, 1 << 22), ("Fr", 1 << 22, 1),
          ("Fr", 1 << 21, 1 << 21), ("Fp", 1 << 16, 1 << 16))
K1_NTT = (1 << 22, 1 << 21)
K1_INV = (1, 1 << 16)
# entries a checkout may lack: each has a stand-in on its multiply
K1_NEW = (fk.K_NTT.symbol, fk.K_INV.symbol)


def select_kernels() -> dict:
    """{name: (plain version, acc planes, Q planes, Fp multiplies per
    active lane)} of the add-select kernels K2-K5."""
    out = {}
    for kind, nfp in (("g1", 1), ("g2", 2)):
        for (kern, _, plain, n_mul), q_coords in zip(cs.CURVE_KERNELS[kind],
                                                     (2, 3)):
            out[kern.name] = (plain, 3 * nfp, q_coords * nfp, n_mul)
    return out


def full_add_kernels() -> dict:
    """{name: (plain version, planes of P, Q and out, Fp multiplies per
    lane)} of the full adds K6/K7."""
    return {kern.name: (plain, 3 if kind == "g1" else 6, n_mul)
            for kern, _, plain, kind, n_mul in cs.FULL_ADD_KERNELS}


PROBE = r"""
#include "fp_lazy.cuh"
#include "mont_ptx.cuh"

namespace {
__device__ bz::lazy::Fp ld(const uint32_t* p, long long n, long long i) {
  bz::lazy::Fp e;
#pragma unroll
  for (int j = 0; j < 12; ++j) e.w[j] = p[j * n + i];
  return e;
}
__device__ void st(uint32_t* p, long long n, long long i,
                   const bz::lazy::Fp& e) {
#pragma unroll
  for (int j = 0; j < 12; ++j) p[j * n + i] = e.w[j];
}
}  // namespace

#define PROBE_KERNEL(name, expr)                                          \
  extern "C" __global__ void name(const uint32_t* a, const uint32_t* b,   \
                                  uint32_t* r, long long n) {             \
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; \
    if (i >= n) return;                                                   \
    const bz::lazy::Fp x = ld(a, n, i), y = ld(b, n, i);                  \
    st(r, n, i, expr);                                                    \
  }
PROBE_KERNEL(probe_lazy_mul1, bz::lazy::mul(x, y))
PROBE_KERNEL(probe_lazy_mul2, bz::lazy::mul(bz::lazy::mul(x, y), y))

// Fr: K1's product (mont_ptx.cuh, one final subtract)
namespace {
using FrE = bz::ptx::Elem<bz::ptx::FrMod>;
__device__ FrE k1_fr(const FrE& a, const FrE& b) {
  return bz::ptx::reduce_once<bz::ptx::FrMod, false>(
      bz::ptx::mul<bz::ptx::FrMod>(a, b));
}
}  // namespace

#define PROBE_FR(name, expr)                                              \
  extern "C" __global__ void name(const uint32_t* a, const uint32_t* b,   \
                                  uint32_t* r, long long n) {             \
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; \
    if (i >= n) return;                                                   \
    FrE x, y;                                                             \
    for (int j = 0; j < 8; ++j) {                                         \
      x.w[j] = a[j * n + i];                                              \
      y.w[j] = b[j * n + i];                                              \
    }                                                                     \
    const FrE z = expr;                                                   \
    for (int j = 0; j < 8; ++j) r[j * n + i] = z.w[j];                    \
  }
PROBE_FR(probe_k1fr_mul1, k1_fr(x, y))
PROBE_FR(probe_k1fr_mul2, k1_fr(k1_fr(x, y), y))

// out planes: mul, add, sub, canon(a); a, b word-major (12, n)
extern "C" __global__ void probe_ops(const uint32_t* a, const uint32_t* b,
                                     uint32_t* out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bz::lazy::Fp x = ld(a, n, i), y = ld(b, n, i);
  st(out, n, i, bz::lazy::mul(x, y));
  st(out + 12 * n, n, i, bz::lazy::add(x, y));
  st(out + 24 * n, n, i, bz::lazy::sub(x, y));
  st(out + 36 * n, n, i, bz::lazy::canon(x));
}

extern "C" int bz_probe_ops(const uint32_t* a, const uint32_t* b,
                            uint32_t* out, long long n, void* stream) {
  probe_ops<<<(unsigned)((n + 127) / 128), 128, 0, (cudaStream_t)stream>>>(
      a, b, out, n);
  return (int)cudaGetLastError();
}
"""


def emit(obj):
    print(json.dumps(obj), flush=True)


# ------------------------------------------------------------ builds


def load_cuda_module(label: str, root: Path):
    """Another checkout's `bazuka_tpu_torch/ops/_cuda.py`, loaded on its own
    (it imports nothing of its package), so that it builds and loads that
    checkout's sources."""
    path = root / "bazuka_tpu_torch" / "ops" / "_cuda.py"
    spec = importlib.util.spec_from_file_location(f"_kernel_ab_{label}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_probe() -> Path:
    PROBE_BUILD.mkdir(parents=True, exist_ok=True)
    src, out = PROBE_BUILD / "probe.cu", PROBE_BUILD / "probe.so"
    src.write_text(PROBE)
    subprocess.run([_cuda.nvcc_path(), *_cuda.FLAGS, "-I", str(_cuda.CSRC),
                    "-o", str(out), str(src)], check=True,
                   capture_output=True, text=True)
    return out


def ptxas_kernels(log: str) -> list:
    """Per-kernel rows of a `-Xptxas -v` log: [{function, registers,
    spill_stores, stack_frame, smem}]."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"function": m.group(1)}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m:
            cur["stack_frame"] = int(m.group(1))
            cur["spill_stores"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(s.group(1)) if s else 0
    return rows


def demangle(names):
    out = subprocess.run(["c++filt"], input="\n".join(names),
                         capture_output=True, text=True)
    got = out.stdout.splitlines() if out.returncode == 0 else []
    return got if len(got) == len(names) else list(names)


def find_symbols(label: str, mod, symbols, optional=()) -> dict:
    """{symbol: ctypes function} from a checkout's libraries; emits the
    ptxas rows of each source that exports one of them.  Symbols in
    `optional` may be missing."""
    found = {}
    for source in mod.SOURCES:
        lib = mod.load(source)
        here = [s for s in symbols if getattr(lib, s, None) is not None]
        if not here:
            continue
        found.update({s: getattr(lib, s) for s in here})
        log_path = mod.lib_path(source).with_suffix(".log")
        rows = ptxas_kernels(log_path.read_text()) if log_path.exists() else []
        for r, name in zip(rows, demangle([r["function"] for r in rows])):
            emit({"phase": "build", "checkout": label, "source": source,
                  "kernel": name, **{k: r.get(k) for k in
                                     ("registers", "spill_stores",
                                      "stack_frame", "smem")}})
    missing = [s for s in symbols if s not in found and s not in optional]
    if missing:
        raise SystemExit(f"{label}: no library exports {missing}")
    return found


# ------------------------------------------------------------ SASS count


def sass_counts(so: Path) -> dict:
    """{function: {opcode: count}} from cuobjdump -sass of a library."""
    cuobjdump = Path(_cuda.nvcc_path()).parent / "cuobjdump"
    txt = subprocess.run([str(cuobjdump), "-sass", str(so)],
                         capture_output=True, text=True, check=True).stdout
    out, cur = {}, None
    for line in txt.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if m and cur is not None:
            op = m.group(1)
            if op.split(".")[0] in ("NOP", "BRA", "EXIT"):
                continue
            cur[op] = cur.get(op, 0) + 1
    return out


def sass_phase(probe_so: Path):
    counts = sass_counts(probe_so)
    res = {}
    for kind in ("lazy", "k1fr"):
        one, two = counts[f"probe_{kind}_mul1"], counts[f"probe_{kind}_mul2"]
        diff = {op: two.get(op, 0) - one.get(op, 0)
                for op in set(one) | set(two)}
        res[kind] = {"instructions": sum(diff.values()),
                     "imad": sum(v for op, v in diff.items()
                                 if op.startswith("IMAD")),
                     "by_opcode": {k: v for k, v in sorted(diff.items())
                                   if v}}
    emit({"phase": "sass",
          "per_fp_mul": {"lazy": res["lazy"]},
          "bound_imad": cs.mont_mul_imads(FP_LIMBS),
          "per_fr_mul": {"k1": res["k1fr"]},
          "bound_imad_fr": cs.mont_mul_imads(16)})


def kernel_sass(mods: dict,
                sources=("add_select.cu", "mont_mul.cu", "curve_add.cu")):
    """Per checkout, the SASS count of every kernel function in those of
    its libraries of `sources` that it has, and for each function of its
    `add_select.cu` whether its opcodes equal this tree's."""
    by = {}
    for label, mod in mods.items():
        for source in sources:
            if source not in mod.SOURCES:
                continue
            raw = sass_counts(mod.lib_path(source))
            # by demangled name: the mangled one hashes the file's path
            counts = dict(zip(demangle(list(raw)), raw.values()))
            by[(label, source)] = counts
            for name, ops in counts.items():
                row = {"phase": "sass_kernel", "checkout": label,
                       "source": source, "kernel": name,
                       "instructions": sum(ops.values())}
                if label != "tree" and source == "add_select.cu":
                    ref = by.get(("tree", source), {}).get(name)
                    row["same_as_tree"] = ref == ops
                emit(row)


# ------------------------------------------------------------ ops probe


def _words_tensor(vals, device):
    arr = np.array([[(v >> (32 * j)) & 0xFFFFFFFF for v in vals]
                    for j in range(12)], dtype=np.uint32)
    return torch.from_numpy(arr.view(np.int32)).to(device)


def _tensor_ints(t):
    arr = t.cpu().numpy().view(np.uint32).astype(object)
    return [sum(int(arr[j, i]) << (32 * j) for j in range(12))
            for i in range(arr.shape[1])]


def ops_phase(probe_so: Path, device) -> bool:
    edge = [0, 1, P - 1, P, P + 1, 2 * P - 1]
    rng = np.random.default_rng(5)
    rand = [int.from_bytes(rng.bytes(48), "little") % (2 * P)
            for _ in range(4096)]
    a = [x for x in edge for _ in edge] + rand[:2048]
    b = [y for _ in edge for y in edge] + rand[2048:]
    n = len(a)
    ta, tb = _words_tensor(a, device), _words_tensor(b, device)
    out = torch.empty((4 * 12, n), dtype=torch.int32, device=device)
    fn = ctypes.CDLL(str(probe_so)).bz_probe_ops
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                           ctypes.c_void_p]
    rc = fn(_cuda.ptr(ta), _cuda.ptr(tb), _cuda.ptr(out), n,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise SystemExit(f"probe_ops: CUDA error {rc}")
    torch.cuda.synchronize()
    mul, add, sub, can = (_tensor_ints(out[12 * k:12 * (k + 1)])
                          for k in range(4))
    r_inv = pow(1 << 384, -1, P)
    bad = {"mul": 0, "add": 0, "sub": 0, "canon": 0}
    for i, (x, y) in enumerate(zip(a, b)):
        bad["mul"] += not (mul[i] < 2 * P and mul[i] % P == x * y * r_inv % P)
        bad["add"] += not (add[i] < 2 * P and add[i] % P == (x + y) % P)
        bad["sub"] += not (sub[i] < 2 * P and sub[i] % P == (x - y) % P)
        bad["canon"] += can[i] != x % P
    emit({"phase": "ops", "n": n, "wrong": bad})
    return not any(bad.values())


# ------------------------------------------------------------ A/B


def random_lanes(planes: int, L: int, gen, device):
    """(planes, 24, L) canonical Fp limbs, with lanes 5 mod 8 all p - 1 and
    lanes 6 mod 8 alternating p - 1 / 0 by plane."""
    F = fp_field()
    x = cs.random_field_limbs(F, planes * L, gen, device)
    x = x.view(planes, L, FP_LIMBS).permute(0, 2, 1).contiguous()
    pm1 = torch.tensor([(P - 1 >> (16 * k)) & 0xFFFF for k in range(24)],
                       dtype=torch.int32, device=device)
    x[:, :, 5::8] = pm1[None, :, None]
    for pl in range(planes):
        x[pl, :, 6::8] = pm1[:, None] if pl % 2 == 0 else 0
    return x


def masks(L: int, gen, device) -> dict:
    lane = torch.arange(L, device=device)
    replay = (lane % 8 != 3) & (torch.rand(L, generator=gen,
                                           device=device) < 0.9)
    replay[5::8] = True
    replay[6::8] = True
    return {"replay": replay.contiguous(),
            "drain": (lane >= L // 2).contiguous(),
            "merge": (lane % 8192 < 2048).contiguous(),
            "full": torch.ones(L, dtype=torch.bool, device=device)}


def bind(fn, symbol: str, *tensors):
    """A launcher of one C entry point over `tensors`' pointers (acc, Q,
    mask, out or P, Q, out), its arguments bound once, so the timed loop
    spends little host time per launch."""
    fn.argtypes = [ctypes.c_void_p] * len(tensors) + [ctypes.c_longlong,
                                                      ctypes.c_longlong,
                                                      ctypes.c_void_p]
    fn.restype = ctypes.c_int
    args = [_cuda.ptr(t) for t in tensors]
    L = tensors[0].shape[-1]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def launch():
        rc = fn(*args, L, 0, stream)
        if rc != 0:
            raise SystemExit(f"{symbol}: CUDA error {rc}")
    return launch


def ab_case(fns: dict, name: str, L: int, mname: str, active: int,
            operands, plain, nbytes: int, imads: int) -> bool:
    """One kernel at one lane count in every checkout: bit for bit against
    `plain(*operands)`, then timed in two turns; emits its `ab` row and
    returns whether every checkout agreed."""
    symbol = _cuda.REGISTRY[name].symbol
    labels = tuple(fns)
    outs = {b: torch.empty_like(operands[0]) for b in labels}
    launch = {b: bind(fns[b][symbol], symbol, *operands, outs[b])
              for b in labels}
    for b in labels:
        launch[b]()
    ref = plain(*operands)
    torch.cuda.synchronize()
    equal = {b: bool(torch.equal(outs[b], ref)) for b in labels}
    times = {b: [] for b in labels}
    for turn in (labels, labels[::-1]):
        for b in turn:
            times[b].append(cs.cuda_ms(launch[b], 10))
    bound_ms, bound_by = cs.bound(nbytes, imads)
    ms = {b: sum(t) / 2 for b, t in times.items()}
    emit({"phase": "ab", "kernel": name, "lanes": L, "mask": mname,
          "active": active, "bound_ms": bound_ms, "bound_by": bound_by,
          "equal": equal, "ms": ms,
          "roofline": {b: bound_ms / t for b, t in ms.items()},
          "turns": times})
    return all(equal.values())


def ab_phase(fns: dict, device) -> bool:
    """fns: {checkout label: {symbol: ctypes function}}."""
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    ok = True
    imads = cs.mont_mul_imads(FP_LIMBS)
    for name, (plain, n_acc, n_q, n_mul) in select_kernels().items():
        for L in LANES:
            acc = random_lanes(n_acc, L, gen, device)
            q = random_lanes(n_q, L, gen, device)
            for mname, mask in masks(L, gen, device).items():
                active = int(mask.sum())
                # acc read and out written in every lane, Q read where active
                nbytes = (L * (2 * n_acc * FP_LIMBS * 4 + 1)
                          + active * n_q * FP_LIMBS * 4)
                ok &= ab_case(fns, name, L, mname, active, (acc, q, mask),
                              plain, nbytes, active * n_mul * imads)
    for name, (plain, planes, n_mul) in full_add_kernels().items():
        for L in FULL_LANES:
            p = random_lanes(planes, L, gen, device)
            q = random_lanes(planes, L, gen, device)
            ok &= ab_case(fns, name, L, "none", L, (p, q), plain,
                          3 * L * planes * FP_LIMBS * 4, L * n_mul * imads)
    return ok


# ------------------------------------------------------------ K1


def c_fn(fn, n_ptrs: int):
    """A ctypes entry point of K1's C interface: pointers, two int64s and
    the stream."""
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs
                   + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call(*args):
        ptrs, n, extra = args[:n_ptrs], args[n_ptrs], args[n_ptrs + 1]
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*[_cuda.ptr(t) for t in ptrs], n, extra,
                ctypes.c_void_p(stream))
        if rc != 0:
            raise SystemExit(f"CUDA error {rc} at launch")
    return call


def mul_with(F, call):
    """a·b on (..., n) limbs through a checkout's multiply entry, as its
    wrapper hands it rows (b repeating over a's leading axes)."""
    def mul(a, b):
        a = a.contiguous()
        b = b.contiguous()
        out = torch.empty(torch.broadcast_shapes(a.shape, b.shape),
                          dtype=torch.int32, device=a.device)
        n = out.numel() // F.n
        if tuple(a.shape) != tuple(out.shape):
            a, b = b, a
        call(a, b, out, n, b.numel() // F.n)
        return out
    return mul


def stage_loop(mul, a, tw):
    """The radix-2 stage loop that ntt_mont ran before the stage entry: the
    plain version's stages over the whole array, K1 per stage through
    `mul`, PyTorch's add, sub and stack around it."""
    F = fr_field()
    n = a.shape[0]
    return fk._stages(F, a.reshape(1, n, F.n), tw, 0, n.bit_length() - 1,
                      mul).reshape(n, F.n)


def _mul_runs(F, call, a, b):
    mul = mul_with(F, call)
    return (lambda: mul(a, b),) * 2


def _ntt_runs(f: dict, x, tw):
    """(checked, timed) calls of a checkout's NTT stages at x's size: its
    stage entry (in place: on a copy, then on a work buffer), else the
    stage loop on its multiply."""
    if fk.K_NTT.symbol not in f:
        mul = mul_with(fr_field(), c_fn(f[fk.K_FR.symbol], 3))
        return (lambda: stage_loop(mul, x, tw),) * 2
    call, work, n = c_fn(f[fk.K_NTT.symbol], 3), x.clone(), x.shape[0]

    def stages(buf):
        call(buf, torch.empty_like(buf), tw, n, 0)
        return buf
    return (lambda: stages(x.clone()), lambda: stages(work))


def _inv_runs(f: dict, x):
    """(checked, timed) calls of a checkout's Fp inversion: its entry, else
    pow_mont's chain on its multiply."""
    F = fp_field()
    if fk.K_INV.symbol not in f:
        mul = mul_with(F, c_fn(f[fk.K_FP.symbol], 3))
        return (lambda: F.pow_mont(x, F.p - 2, mul=mul),) * 2
    call = c_fn(f[fk.K_INV.symbol], 2)

    def inv():
        out = torch.empty_like(x)
        call(x, out, x.shape[0], 0)
        return out
    return (inv, inv)


def k1_cases(fns: dict, device) -> list:
    """(entry, size, {checkout: (checked call, timed call)}, plain call,
    bytes, IMADs) for K1's entries at the proof's sizes."""
    gen = torch.Generator(device=device)
    gen.manual_seed(4)
    cases = []
    for fname, n, rows in K1_MUL:
        F, kern = ((fr_field(), fk.K_FR) if fname == "Fr"
                   else (fp_field(), fk.K_FP))
        a, b = cs.k1_operands(F, n, rows, gen, device)
        runs = {label: _mul_runs(F, c_fn(f[kern.symbol], 3), a, b)
                for label, f in fns.items()}
        cases.append((kern.name, [n, rows], runs,
                      lambda F=F, a=a, b=b: fk.mont_mul_plain(F, a, b),
                      (2 * n + rows) * F.n * 4, n * cs.mont_mul_imads(F.n)))
    for n in K1_NTT:
        x, tw = cs.ntt_operands(n, gen, device)
        runs = {label: _ntt_runs(f, x, tw) for label, f in fns.items()}
        cases.append((fk.K_NTT.name, [n], runs,
                      lambda x=x, tw=tw: fk.ntt_stages_plain(x, tw),
                      (3 * n - 1) * 16 * 4, cs.ntt_imads(n)))
    F = fp_field()
    for n in K1_INV:
        x = cs.inv_operands(n, gen, device)
        runs = {label: _inv_runs(f, x) for label, f in fns.items()}
        cases.append((fk.K_INV.name, [n], runs,
                      lambda x=x: fk.mont_inv_plain(F, x), 2 * n * F.n * 4,
                      n * cs.INV_FP_IMADS))
    return cases


def k1_phase(fns: dict, device) -> bool:
    ok = True
    for name, size, runs, plain, nbytes, imads in k1_cases(fns, device):
        labels = tuple(runs)
        want = plain()
        equal = {b: bool(torch.equal(runs[b][0](), want)) for b in labels}
        ok &= all(equal.values())
        times = {b: [] for b in labels}
        for turn in (labels, labels[::-1]):
            for b in turn:
                times[b].append(cs.cuda_ms(runs[b][1], 3))
        bound_ms, bound_by = cs.bound(nbytes, imads)
        ms = {b: sum(t) / 2 for b, t in times.items()}
        emit({"phase": "k1", "kernel": name, "size": size,
              "bound_ms": bound_ms, "bound_by": bound_by, "equal": equal,
              "ms": ms, "roofline": {b: bound_ms / t for b, t in ms.items()},
              "turns": times})
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="*", metavar="LABEL=DIR",
                    help="other checkouts' roots, each with a label")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    mods = {"tree": _cuda}
    for spec in args.checkouts:
        label, _, root = spec.partition("=")
        if not root or label in mods:
            ap.error(f"want a new LABEL=DIR, got {spec!r}")
        mods[label] = load_cuda_module(label, Path(root).resolve())
    device = torch.device("cuda")
    smi = cs.nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    with ThreadPoolExecutor(len(mods) + 1) as ex:
        probe = ex.submit(build_probe)
        builds = [ex.submit(m.build_all) for m in mods.values()]
        for b in builds:
            b.result()
        probe_so = probe.result()
    symbols = [_cuda.REGISTRY[k].symbol
               for k in (*select_kernels(), *full_add_kernels())] + [
        k.symbol for k in (fk.K_FR, fk.K_FP, fk.K_NTT, fk.K_INV)]
    fns = {label: find_symbols(label, m, symbols, optional=K1_NEW)
           for label, m in mods.items()}
    sass_phase(probe_so)
    kernel_sass(mods)
    ok = ops_phase(probe_so, device)
    ok &= ab_phase(fns, device)
    ok &= k1_phase(fns, device)
    print(smi, flush=True)
    emit({"ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
