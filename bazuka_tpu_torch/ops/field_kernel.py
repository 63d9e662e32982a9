"""Kernel K1: the Montgomery multiply a·b·R^-1 mod p over Fr or Fp, and the
two entries built on it.

Replaces the Pallas kernel `bazuka_tpu/ops/pallas_field.py:_mont_mul_call`
(body `_kernel_body`, API `pallas_mont_mul`) and, where the JAX package
fused that multiply into a jitted program, the program around it: the NTT's
radix-2 stage loop (`bazuka_tpu/ops/ntt.py`) and the Fermat inversion
(`bazuka_tpu/ops/weierstrass.py:_fermat_inv_fn`).  The CUDA source is
`csrc/mont_mul.cu`, on the PTX field core of `csrc/mont_ptx.cuh`:

  mont_mul(F, a, b)    K1 Fr, K1 Fp: the batched multiply
  ntt_stages_(a, tw)   K1 Fr NTT stages: every radix-2 stage of an NTT of
                       bit-reversed (n, 16) Montgomery limbs, in place,
                       over the whole array or each row of a batch
  mont_inv(F, a)       K1 Fp inversion: a^(p-2), 0 -> 0, over Fp

Each runs its plain version on a CPU tensor and launches its kernel on a
CUDA tensor, or raises.  The kernels read and write whole 16-byte-aligned
rows; a wrapper copies a view that is not contiguous or not so aligned.
"""

from __future__ import annotations

import math

import torch

from ..fields.limbs import fr_field
from . import _cuda

_SRC = "mont_mul.cu"
_PALLAS = "bazuka_tpu/ops/pallas_field.py:106"
K_FR = _cuda.register(_cuda.CudaKernel(
    "mont_mul_fr", _SRC, "bz_mont_mul_fr", 3, _PALLAS))
K_FP = _cuda.register(_cuda.CudaKernel(
    "mont_mul_fp", _SRC, "bz_mont_mul_fp", 3, _PALLAS))
K_NTT = _cuda.register(_cuda.CudaKernel(
    "ntt_stages_fr", _SRC, "bz_ntt_stages_fr", 3, _PALLAS))
K_INV = _cuda.register(_cuda.CudaKernel(
    "mont_inv_fp", _SRC, "bz_mont_inv_fp", 2, _PALLAS))

# stages run in shared memory by the NTT's first pass: blocks of 2^10
# elements (32 KiB of packed words), NTT_LOW_MAX of csrc/mont_mul.cu
NTT_LOW_LOG = 10


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` if it is contiguous and starts on a 16-byte boundary, else a
    copy that is."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _device(*ts) -> str:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"operands on {[str(t.device) for t in ts]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type


# ------------------------------------------------ the batched multiply


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


def _check_limbs(F, *ts):
    for t in ts:
        if t.dtype != torch.int32:
            raise TypeError("K1 takes int32 limb tensors")
        if t.shape[-1] != F.n:
            raise ValueError(f"last axis must hold {F.n} limbs")


def _kernel(F, a, b):
    kern = {"Fr": K_FR, "Fp": K_FP}.get(F.name)
    if kern is None:
        raise ValueError(f"no CUDA kernel for field {F.name}")
    _check_limbs(F, a, b)
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
    kern.launch((_aligned(a), _aligned(b), out), B, rows)
    return out


def mont_mul(F, a, b):
    """a·b·R^-1 mod p on (..., n) int32 limbs that broadcast against each
    other; canonical output.  A `b` that repeats over leading axes (a
    constant, a table of twiddles) is passed once: the kernel reads row
    e mod b_rows for element e."""
    if _device(a, b) == "cpu":
        return mont_mul_plain(F, a, b)
    return _kernel(F, a, b)


# ---------------------------------------------------- the NTT's stages


def _stages(F, a, tw, lo: int, hi: int, mul=None):
    """Radix-2 stages lo..hi-1 on each block of a (B, m, 16): stage s views
    a block as (m / 2h, 2, h) pairs, h = 2^s, and takes its twiddles from
    rows [h - 1, 2h - 1) of tw.  The products go through `mul` (default
    the plain multiply)."""
    mul = mul or (lambda x, y: mont_mul_plain(F, x, y))
    B, m, nl = a.shape
    for s in range(lo, hi):
        half = 1 << s
        a = a.reshape(B, m // (2 * half), 2, half, nl)
        u = a[:, :, 0]
        v = mul(a[:, :, 1], tw[half - 1:2 * half - 1])
        a = torch.stack([F.add(u, v), F.sub(u, v)], dim=2)
    return a.reshape(B, m, nl)


def _row_log(n: int, row: int) -> int:
    """log2 m for n elements in rows of m (0: one row of n); raises unless
    m is a power of two that divides n."""
    m = row or n
    log_m = m.bit_length() - 1
    if m < 1 or m != 1 << log_m or n % m:
        raise ValueError(f"want rows of a power of two dividing {n}, "
                         f"not {m}")
    return log_m


def ntt_stages_plain(a, tw, low_log: int = NTT_LOW_LOG, row: int = 0):
    """The plain version, at the kernel's interface: `a` is n / m rows of
    m bit-reversed Montgomery limbs ((n, 16); `row` = m, 0 for one row of
    n, a power of two), `tw` the row length's packed (m - 1, 16) stage twiddles; each row
    is transformed on its own.  Stages 0..k-1 run on each block of 2^k
    rows (k = min(low_log, log2 m)), then each remaining stage over each
    row; returns a new tensor.  The kernel's blocks are 2^NTT_LOW_LOG
    rows; the block size cannot change the result, and a smaller
    `low_log` lets a test at a toy size run the single stages too."""
    F = fr_field()
    n = a.shape[0]
    log_m = _row_log(n, row)
    m = 1 << log_m
    k = min(low_log, log_m)
    blocks = _stages(F, a.reshape(n >> k, 1 << k, F.n), tw, 0, k)
    return _stages(F, blocks.reshape(n // m, m, F.n), tw, k, log_m).reshape(
        n, F.n)


def ntt_stages_(a, tw, row: int = 0):
    """Every radix-2 stage of a decimation-in-time NTT over Fr, written
    over `a` ((n, 16) bit-reversed Montgomery limbs, n a power of two) and
    returned; `tw` is the packed (m - 1, 16) table of stage twiddles of
    the row length m.  With `row` = m < n (a power of two dividing n),
    `a` holds n / m rows of m elements, each transformed on its own (the
    four-step NTT's row transforms); 0 means one row of n, which must
    then be a power of two.  On the card `a` must be
    contiguous and 16-byte aligned (`ntt_mont` hands it a fresh gather);
    the kernel uses one scratch tensor of a's size."""
    if _device(a, tw) == "cpu":
        return a.copy_(ntt_stages_plain(a, tw, row=row))
    F = fr_field()
    _check_limbs(F, a, tw)
    n = a.shape[0]
    log_m = _row_log(n, row)
    m = 1 << log_m
    if a.dim() != 2 or tuple(tw.shape) != (m - 1, F.n):
        raise ValueError("want a (n, 16) and tw (m - 1, 16)")
    if not a.is_contiguous() or a.data_ptr() % 16:
        raise ValueError("ntt_stages_ works in place on a contiguous, "
                         "16-byte-aligned tensor")
    if m > 1:
        K_NTT.launch((a, torch.empty_like(a), _aligned(tw)), n,
                     0 if m == n else m)
    return a


# ------------------------------------------------- the Fermat inversion


def fermat_windows(e: int, width: int = 4):
    """Sliding windows of the exponent e from its top bit: (first, steps),
    acc = x^first and then, per (squarings, digit) step, that many
    squarings and one multiply by x^digit (digit odd, below 2^width).
    The tables INV_FIRST/INV_SQR/INV_DIGIT of `csrc/mont_mul.cu` are
    these windows of p - 2."""
    bits = bin(e)[2:]
    steps, i, pending = [], 0, 0
    while i < len(bits):
        if bits[i] == "0":
            pending += 1
            i += 1
            continue
        j = min(i + width, len(bits))
        while bits[j - 1] == "0":
            j -= 1
        steps.append((pending + j - i, int(bits[i:j], 2)))
        pending, i = 0, j
    if pending:
        raise ValueError("an even exponent ends in squarings")
    return steps[0][1], steps[1:]


def mont_inv_plain(F, a):
    """The plain version: F.pow_mont(a, p - 2) over the plain multiply.
    The inverse is unique and 0 maps to 0, so any chain gives these
    limbs."""
    return F.pow_mont(a, F.p - 2, mul=lambda x, y: mont_mul_plain(F, x, y))


def mont_inv(F, a):
    """a^(p-2) (a^-1, and 0 for 0) on (..., n) int32 Montgomery limbs,
    canonical output.  The card has the kernel for Fp only."""
    if _device(a) == "cpu":
        return mont_inv_plain(F, a)
    if F.name != "Fp":
        raise ValueError(f"no CUDA inversion kernel for field {F.name}")
    _check_limbs(F, a)
    out = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    B = math.prod(a.shape[:-1])
    if B:
        K_INV.launch((_aligned(a), out), B)
    return out
