"""The port's host C++ libraries (`csrc/*.cpp`): built with the host's C++
compiler at first use into `bazuka_tpu_torch/_build/`, named by a hash of
the source and the compiler's flags, and loaded with ctypes.

A library that reads Python objects (`python=True`) is compiled against
this interpreter's `Python.h` and loaded with `ctypes.PyDLL`, so its calls
hold the GIL; any other is loaded with `ctypes.CDLL`, whose calls release
it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sysconfig
import threading
from pathlib import Path

from ._cuda import BUILD

FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")


def _flags(python: bool) -> tuple:
    return FLAGS + (("-I", sysconfig.get_paths()["include"]) if python
                    else ())


def lib_path(source: Path, python: bool = False) -> Path:
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(_flags(python)).encode())
    return BUILD / f"{source.stem}_{h.hexdigest()[:16]}.so"


def _build(source: Path, out: Path, python: bool):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise OSError("no C++ compiler")
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *_flags(python), "-o", str(tmp),
                           str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise OSError(f"{cxx} failed for {source.name}:\n{proc.stderr}")
    os.replace(tmp, out)


def load(source: Path, python: bool = False) -> ctypes.CDLL:
    """`source`'s library, built first if it is not there yet.  Raises
    OSError where it cannot be built or loaded."""
    out = lib_path(source, python)
    if not out.exists():
        _build(source, out, python)
    return (ctypes.PyDLL if python else ctypes.CDLL)(str(out))
