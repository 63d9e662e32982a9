"""NTT / iNTT over BLS12-381 Fr for the QAP reduction (port of
`bazuka_tpu/ops/ntt.py`: the radix-2 stage loop, the single-card Bailey
four-step, the batched row transform, coset transforms and the
device-built twiddle and coset tables).

Decimation-in-time radix-2: one bit-reversal gather, then log2(N) stages,
each the butterfly `(a, b) -> (a + w b, a - w b)` over the (N, 16)
Montgomery tensor viewed as (groups, 2, half, 16).  The stages are one call
of `field_kernel.ntt_stages_`: on the card kernel K1's NTT entry (the low
stages in shared memory, then one launch per stage), on the CPU the plain
loop of batched multiplies, adds and subs.  Per-stage twiddles are packed
in one (N-1, 16) table built on the device.

From N = 2^_FOURSTEP_MIN_LOG_N up, `ntt_mont` runs the four-step instead
(`_ntt_mont_fourstep`): N = A·B, transposes, row transforms of length B
and A over chunks of rows (`ntt_mont_batched`, the stage entry over a
batch of rows) and the twiddles w_N^(n1·k2) between them, so that no pass
holds more than a few full-size tensors.  Tables of at most
2^_TABLE_CACHE_MAX_LOG_N rows are cached per (size, direction, device);
larger ones are rebuilt per call, as the JAX package does (at 2^24 the
four cached tables would pin 4 GiB for the process's life).  All three
thresholds are module constants, so tests can lower them.

Unlike the JAX version, nothing here consumes (donates) its input: every
transform returns a new tensor and leaves the caller's tensor as it was,
and its four-step runs on every device (the JAX package's only on its
"jax" backend).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields.host import FR_GENERATOR, FR_MODULUS, FR_TWO_ADICITY
from ..fields.limbs import fr_field
from .field_kernel import ntt_stages_

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


# Above this size, twiddle and coset tables are rebuilt on the device per
# call instead of cached (bazuka_tpu/ops/ntt.py:_TABLE_CACHE_MAX_LOG_N).
_TABLE_CACHE_MAX_LOG_N = 21


def _build_stage_twiddles(log_n: int, inverse: bool, device: str):
    w = root_of_unity(log_n)
    if inverse:
        w = pow(w, -1, P)
    e = torch.from_numpy(_stage_twiddle_exponents(log_n)).to(device)
    return _pow_table(e, w, log_n)


_stage_twiddles_cached = functools.lru_cache(maxsize=None)(
    _build_stage_twiddles)


def _stage_twiddles(log_n: int, inverse: bool, device: str) -> torch.Tensor:
    """All stages' Montgomery twiddles packed in one (n-1, 16) tensor;
    cached up to 2^_TABLE_CACHE_MAX_LOG_N rows, else rebuilt."""
    if log_n <= _TABLE_CACHE_MAX_LOG_N:
        return _stage_twiddles_cached(log_n, inverse, device)
    return _build_stage_twiddles(log_n, inverse, device)


@functools.lru_cache(maxsize=None)
def _rev(log_n: int, device: str) -> torch.Tensor:
    return torch.from_numpy(_bit_reverse_indices(1 << log_n)).to(device)


def _build_coset_scale(log_n: int, inverse: bool, device: str):
    g = FR_GENERATOR if not inverse else pow(FR_GENERATOR, -1, P)
    e = torch.arange(1 << log_n, dtype=torch.int64, device=device)
    return _pow_table(e, g, log_n)


_coset_scale_cached = functools.lru_cache(maxsize=None)(_build_coset_scale)


def _coset_scale(log_n: int, inverse: bool, device: str) -> torch.Tensor:
    """Montgomery powers g^i (or g^-i) of the Fr multiplicative generator,
    for evaluating on / interpolating from the coset gH; cached as the
    stage twiddles are."""
    if log_n <= _TABLE_CACHE_MAX_LOG_N:
        return _coset_scale_cached(log_n, inverse, device)
    return _build_coset_scale(log_n, inverse, device)


def clear_table_cache():
    """Drop every cached twiddle and coset table."""
    _stage_twiddles_cached.cache_clear()
    _coset_scale_cached.cache_clear()


def _log2(n: int) -> int:
    log_n = n.bit_length() - 1
    if n != 1 << log_n:
        raise ValueError(f"size {n} is not a power of two")
    return log_n


# ---------------------------------------------------------------- transforms


def ntt_mont(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """(n, 16) Montgomery limbs -> NTT'd limbs, bit-exact vs ntt_host.
    Returns a new tensor; `x` is left unchanged.  From n =
    2^_FOURSTEP_MIN_LOG_N up this is the four-step (`_ntt_mont_fourstep`),
    whose limbs are the same."""
    n = x.shape[0]
    log_n = _log2(n)
    if log_n >= _FOURSTEP_MIN_LOG_N:
        return _ntt_mont_fourstep(x, log_n, inverse)
    return ntt_mont_batched(x[None], inverse)[0]


def ntt_mont_batched(x: torch.Tensor, inverse: bool = False,
                     scale: bool = True) -> torch.Tensor:
    """(B, n, 16) Montgomery limbs -> the NTT of each row along axis 1, in
    one gather, one call of the stage entry over the B rows and, for the
    inverse with `scale`, one multiply by 1/n (the four-step's inverse
    scales once by 1/N at its end instead).  Returns a new tensor."""
    F = fr_field()
    B, n = x.shape[0], x.shape[1]
    log_n = _log2(n)
    dev = str(x.device)
    tw = _stage_twiddles(log_n, inverse, dev)
    a = x[:, _rev(log_n, dev)].reshape(B * n, F.n)
    a = ntt_stages_(a, tw, row=n).view(B, n, F.n)
    if inverse and scale:
        a = F.mont_mul(a, F.const_mont(pow(n, -1, P), x.device))
    return a


# ------------------------------------------ single-card four-step NTT
#
# Bailey, N = A·B with n = A·n2 + n1, k = B·k1 + k2:
#   X[B·k1 + k2] = Σ_n1 w_A^(n1·k1) · (w_N^(n1·k2) · Σ_n2 x[A·n2 + n1]
#                                       · w_B^(n2·k2))
# reshape to (B, A), transpose, row NTTs of length B, twiddle by
# w_N^(n1·k2), transpose, row NTTs of length A, transpose back
# (bazuka_tpu/ops/ntt.py:238-351).  The row transforms and twiddles run
# over chunks of _FOURSTEP_CHUNK_LANES elements, written back in place, so
# a transform holds its input, two full-size tensors and one chunk's
# transients.

_FOURSTEP_MIN_LOG_N = 23
_FOURSTEP_CHUNK_LANES = 1 << 22  # rows·cols per chunk (268 MB of limbs)


def _twiddle_rows(lo: int, C: int, B: int, w: int, log_n: int, device):
    """(C, B, 16) Montgomery w^((lo + r)·k2 mod N), r < C, k2 < B, by the
    bit decomposition of the exponents (`_pow_table`)."""
    r = torch.arange(lo, lo + C, dtype=torch.int64, device=device)
    k2 = torch.arange(B, dtype=torch.int64, device=device)
    e = (r[:, None] * k2[None, :]) % (1 << log_n)
    return _pow_table(e.reshape(-1), w, log_n).view(C, B, -1)


def _ntt_mont_fourstep(x: torch.Tensor, log_n: int,
                       inverse: bool) -> torch.Tensor:
    F = fr_field()
    log_A = (log_n + 1) // 2
    log_B = log_n - log_A
    A, B = 1 << log_A, 1 << log_B
    w = root_of_unity(log_n)
    if inverse:
        w = pow(w, -1, P)

    def rows_in_place(y, log_m, twiddle):
        """Row NTTs of length 2^log_m over (R, 2^log_m, 16) y, a chunk of
        rows at a time, each chunk times its twiddle rows if `twiddle`."""
        R, m = y.shape[0], y.shape[1]
        C = max(1, min(R, _FOURSTEP_CHUNK_LANES // m))
        for lo in range(0, R, C):
            c = ntt_mont_batched(y[lo:lo + C], inverse, scale=False)
            if twiddle:
                c = F.mont_mul(c, _twiddle_rows(lo, c.shape[0], m, w,
                                                log_n, y.device))
            y[lo:lo + C] = c

    # (N, 16) -> (B, A, 16) -> T: (A, B, 16), rows n1, columns n2 -> k2
    y = x.reshape(B, A, F.n).transpose(0, 1).contiguous()
    rows_in_place(y, log_B, True)
    # T -> (B, A, 16): rows k2, columns n1 -> k1
    y = y.transpose(0, 1).contiguous()
    rows_in_place(y, log_A, False)
    # W[k2, k1] -> T -> (A, B)[k1, k2] -> (N, 16)
    y = y.transpose(0, 1).contiguous().view(1 << log_n, F.n)
    if inverse:
        y = F.mont_mul(y, F.const_mont(pow(1 << log_n, -1, P), x.device))
    return y


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
