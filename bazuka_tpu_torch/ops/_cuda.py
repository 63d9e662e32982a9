"""Build, load and count the port's CUDA kernels.

Each `csrc/*.cu` file is compiled by `nvcc` on its own into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
loaded with `ctypes`.  Libraries go to `bazuka_tpu_torch/_build/`, named by a
hash of the sources and flags, and are built at first use; `build_all()`
starts one `nvcc` per source at once and waits for all of them.

Every C entry point launches on the stream it is given (PyTorch's current
stream of the operands' card, that card made the current device for the
call) and returns `cudaGetLastError()`; `CudaKernel.launch` raises on a
non-zero code and adds one to the kernel's launch count; it also tallies
the launch's sizes, so a caller can replay a run's kernels at the shapes
that run gave them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from collections import Counter
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
HEADERS = ("mont_ptx.cuh", "fp_lazy.cuh")
SOURCES = ("mont_mul.cu", "add_select.cu")
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def lib_path(source: str) -> Path:
    h = hashlib.sha256()
    for name in (source,) + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD / f"{Path(source).stem}_{h.hexdigest()[:16]}.so"


def _start(source: str):
    """Start nvcc for one source; None if the library is already built."""
    out = lib_path(source)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(source: str, started) -> str:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{log}")
    os.replace(tmp, out)
    out.with_suffix(".log").write_text(log)
    return log


def build_all() -> dict:
    """Build every kernel library, one nvcc per source, all at once.
    Returns {source: nvcc/ptxas log} for the sources built now."""
    started = {s: _start(s) for s in SOURCES}
    logs = {}
    try:
        for s, st in started.items():
            if st is not None:
                logs[s] = _finish(s, st)
    finally:
        for st in started.values():
            if st is not None and st[0].poll() is None:
                st[0].kill()
                st[0].wait()
    return logs


def load(source: str) -> ctypes.CDLL:
    if source not in _libs:
        st = _start(source)
        if st is not None:
            _finish(source, st)
        _libs[source] = ctypes.CDLL(str(lib_path(source)))
    return _libs[source]


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


class CudaKernel:
    """One C entry point of a kernel library, with its launch count."""

    def __init__(self, name: str, source: str, symbol: str, n_ptrs: int,
                 replaces: str):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.n_ptrs = n_ptrs
        self.replaces = replaces
        self.launches = 0
        self.sizes: Counter = Counter()  # (n, extra) -> launches
        self._fn = None

    def _get(self):
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            # pointers..., n (int64), extra int64, stream
            fn.argtypes = ([ctypes.c_void_p] * self.n_ptrs
                           + [ctypes.c_longlong, ctypes.c_longlong,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, tensors, n: int, extra: int = 0):
        fn = self._get()
        dev = tensors[0].device
        # the operands' card is the current device for the launch: on a
        # mesh over several cards the caller's current device may be
        # another one, whose context knows neither the stream nor the data
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(*[ptr(t) for t in tensors], n, extra,
                    ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA error {rc} at launch")
        self.launches += 1
        self.sizes[(n, extra)] += 1


REGISTRY: dict = {}


def register(kernel: CudaKernel) -> CudaKernel:
    REGISTRY[kernel.name] = kernel
    return kernel


def reset_counts():
    for k in REGISTRY.values():
        k.launches = 0
        k.sizes.clear()


def counts() -> dict:
    return {name: k.launches for name, k in REGISTRY.items()}


def sizes() -> dict:
    """{kernel name: {(n, extra): launches}} since the last reset."""
    return {name: dict(k.sizes) for name, k in REGISTRY.items()}
