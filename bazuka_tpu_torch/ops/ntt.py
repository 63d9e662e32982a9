"""NTT / iNTT over BLS12-381 Fr for the QAP reduction (port of
`bazuka_tpu/ops/ntt.py`: the radix-2 stage loop, coset transforms and the
device-built twiddle and coset tables).

Decimation-in-time radix-2: one bit-reversal gather, then log2(N) stages.
Each stage views the (N, 16) Montgomery tensor as (groups, 2, half, 16) so
the butterfly `(a, b) -> (a + w b, a - w b)` is one batched Montgomery
multiply (kernel K1 on the card) plus an add and a sub.  Per-stage twiddles
are packed in one (N-1, 16) table built on the device.

Unlike the JAX version, nothing here consumes its input: every transform
returns a new tensor and leaves the caller's tensor as it was.  Tables are
cached per (size, direction, device); at the prover's 2^22 they are a few
hundred MB, which an 80 GB card keeps.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields.host import FR_GENERATOR, FR_MODULUS, FR_TWO_ADICITY
from ..fields.limbs import fr_field

P = FR_MODULUS


@functools.cache
def root_of_unity(log_n: int) -> int:
    """Primitive 2^log_n-th root of unity in Fr."""
    if log_n > FR_TWO_ADICITY:
        raise ValueError(f"domain 2^{log_n} exceeds Fr 2-adicity {FR_TWO_ADICITY}")
    return pow(FR_GENERATOR, (P - 1) >> log_n, P)


# ------------------------------------------------------------ device tables


def _bit_reverse_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def _pow_table(exps: torch.Tensor, base: int, log_n: int) -> torch.Tensor:
    """(m,) int64 exponents -> (m, 16) Montgomery base^e, via the bit
    decomposition e = Σ bit_k(e)·2^k: log_n full-width masked multiplies
    against host-computed base^(2^k), no per-element host loop."""
    F = fr_field()
    dev = exps.device
    one = F.const_mont(1, dev)
    acc = one.expand(exps.shape[0], F.n).contiguous()
    b = base % P
    for k in range(log_n):
        wk = F.const_mont(b, dev)
        bit = ((exps >> k) & 1).bool()
        acc = F.mont_mul(acc, torch.where(bit[:, None], wk, one))
        b = b * b % P
    return acc


def _stage_twiddle_exponents(log_n: int) -> np.ndarray:
    """(n-1,) exponents e(r) such that packed twiddle row r = w^e(r):
    stage s (half=2^s, w_m = w^(n >> (s+1))) owns rows
    [2^s - 1, 2^(s+1) - 1) holding w_m^0..w_m^(half-1)."""
    n = 1 << log_n
    r = np.arange(1, n, dtype=np.int64)  # r = packed row + 1 in [1, n)
    s = np.floor(np.log2(r)).astype(np.int64)  # stage of row r-1
    j = r - (np.int64(1) << s)
    return j * (n >> (s + 1))


@functools.lru_cache(maxsize=None)
def _stage_twiddles(log_n: int, inverse: bool, device: str) -> torch.Tensor:
    w = root_of_unity(log_n)
    if inverse:
        w = pow(w, -1, P)
    e = torch.from_numpy(_stage_twiddle_exponents(log_n)).to(device)
    return _pow_table(e, w, log_n)


@functools.lru_cache(maxsize=None)
def _rev(log_n: int, device: str) -> torch.Tensor:
    return torch.from_numpy(_bit_reverse_indices(1 << log_n)).to(device)


@functools.lru_cache(maxsize=None)
def _coset_scale(log_n: int, inverse: bool, device: str) -> torch.Tensor:
    """Montgomery powers g^i (or g^-i) of the Fr multiplicative generator,
    for evaluating on / interpolating from the coset gH."""
    g = FR_GENERATOR if not inverse else pow(FR_GENERATOR, -1, P)
    e = torch.arange(1 << log_n, dtype=torch.int64, device=device)
    return _pow_table(e, g, log_n)


def _log2(n: int) -> int:
    log_n = n.bit_length() - 1
    if n != 1 << log_n:
        raise ValueError(f"size {n} is not a power of two")
    return log_n


# ---------------------------------------------------------------- transforms


def ntt_mont(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """(n, 16) Montgomery limbs -> NTT'd limbs, bit-exact vs ntt_host.
    Returns a new tensor; `x` is left unchanged."""
    F = fr_field()
    n = x.shape[0]
    log_n = _log2(n)
    dev = str(x.device)
    tw = _stage_twiddles(log_n, inverse, dev)
    a = x[_rev(log_n, dev)]
    for s in range(log_n):
        half = 1 << s
        a = a.reshape(n // (2 * half), 2, half, F.n)
        u = a[:, 0]
        v = F.mont_mul(a[:, 1], tw[half - 1 : 2 * half - 1])
        a = torch.stack([F.add(u, v), F.sub(u, v)], dim=1)
    a = a.reshape(n, F.n)
    if inverse:
        a = F.mont_mul(a, F.const_mont(pow(n, -1, P), x.device))
    return a


def coset_ntt_mont(x: torch.Tensor) -> torch.Tensor:
    """Evaluate a polynomial (coefficient form) over the coset gH."""
    F = fr_field()
    scaled = F.mont_mul(x, _coset_scale(_log2(x.shape[0]), False, str(x.device)))
    return ntt_mont(scaled, False)


def coset_intt_mont(x: torch.Tensor) -> torch.Tensor:
    """Interpolate from coset-gH evaluations back to coefficients."""
    F = fr_field()
    coeffs = ntt_mont(x, True)
    return F.mont_mul(coeffs, _coset_scale(_log2(x.shape[0]), True, str(x.device)))
