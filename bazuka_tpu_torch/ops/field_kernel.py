"""Kernel K1: batched Montgomery multiply a·b·R^-1 mod p over Fr or Fp.

Replaces the Pallas kernel `bazuka_tpu/ops/pallas_field.py:_mont_mul_call`
(body `_kernel_body`, API `pallas_mont_mul`).  The CUDA source is
`csrc/mont_mul.cu`: one element per thread, 16-bit limbs packed into 32-bit
words, CIOS Montgomery with 64-bit partial products, canonical output.

`mont_mul(F, a, b)` takes (..., n) int32 limb tensors that broadcast
against each other.  On a CPU tensor it runs `mont_mul_plain`; on a CUDA
tensor it launches the kernel at every batch size, or raises.  A `b` that
repeats over leading axes (a constant, or per-stage NTT twiddles) is passed
once: the kernel reads row `e % b_rows` for element e.
"""

from __future__ import annotations

import math

import torch

from . import _cuda

K_FR = _cuda.register(_cuda.CudaKernel(
    "mont_mul_fr", "mont_mul.cu", "bz_mont_mul_fr", 3,
    "bazuka_tpu/ops/pallas_field.py:106"))
K_FP = _cuda.register(_cuda.CudaKernel(
    "mont_mul_fp", "mont_mul.cu", "bz_mont_mul_fp", 3,
    "bazuka_tpu/ops/pallas_field.py:106"))


def mont_mul_plain(F, a, b):
    """The plain version: REDC(mul_wide(a, b)) in int64 arithmetic."""
    return F._narrow(F.redc(F.mul_wide(F._wide(a), F._wide(b))))


def _repeat_rows(x: torch.Tensor, full: tuple):
    """Rows of `x` if it equals `full` up to leading size-1 axes (so that
    element e of the flattened `full` batch uses row e % rows), else None."""
    shape = (1,) * (len(full) - x.dim()) + tuple(x.shape)
    k = 0
    while k < len(full) - 1 and shape[k] == 1:
        k += 1
    if tuple(shape[k:]) != tuple(full[k:]):
        return None
    return math.prod(full[k:-1])


def _kernel(F, a, b):
    n = F.n
    kern = {"Fr": K_FR, "Fp": K_FP}.get(F.name)
    if kern is None:
        raise ValueError(f"no CUDA kernel for field {F.name}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("mont_mul kernel takes int32 limb tensors")
    if a.shape[-1] != n or b.shape[-1] != n:
        raise ValueError(f"last axis must hold {n} limbs")
    full = tuple(torch.broadcast_shapes(a.shape, b.shape))
    B = math.prod(full[:-1])
    out = torch.empty(full, dtype=torch.int32, device=a.device)
    if B == 0:
        return out
    if tuple(a.shape) != full:
        a, b = b, a  # Montgomery multiply commutes
    rows = _repeat_rows(b, full) if tuple(a.shape) == full else None
    if rows is None:
        a = a.expand(full)
        b = b.expand(full)
        rows = B
    a = a.contiguous()
    b = b.contiguous()
    kern.launch((a, b, out), B, rows)
    return out


def mont_mul(F, a, b):
    """a·b·R^-1 mod p on (..., n) int32 limbs; canonical output."""
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.device.type == "cpu":
        return mont_mul_plain(F, a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    return _kernel(F, a, b)
