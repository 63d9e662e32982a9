"""Multi-limb prime-field engine in PyTorch (port of `bazuka_tpu/fields/limbs.py`).

Big integers are little-endian 16-bit limbs, shape `(..., n_limbs)`, stored
as **int32 tensors holding 16-bit payloads** — the same bits as the JAX
package's uint32 layout (`np.asarray(x, np.uint32).view(np.int32)` converts).
PyTorch's CPU build has no uint32 add, shift or compare, so the plain
arithmetic below widens to int64 for products and carries and narrows back
to int32 at every public function.

Montgomery form uses R = 2^(16·n) exactly as the JAX engine does (2^256 for
Fr, 2^384 for Fp), and every result is canonical (< p), so the port's limbs
match the JAX package's limb for limb.

`mont_mul` and `inv_mont` are this module's kernels: on a CUDA tensor they
launch the hand-written Montgomery multiply and Fp inversion of
`ops.field_kernel` (kernel K1); on a CPU tensor they run the plain versions,
`redc(mul_wide(a, b))` below and `pow_mont` over it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve_device
from .host import FP_MODULUS, FR_MODULUS

MASK = 0xFFFF
W = 16  # bits per limb


# ------------------------------------------------------------ host helpers


def int_to_limbs(x: int, n: int) -> np.ndarray:
    """Python int -> (n,) uint32 array of 16-bit limbs (little-endian)."""
    return np.array([(x >> (W * i)) & 0xFFFF for i in range(n)], dtype=np.uint32)


def ints_to_array(xs, n: int) -> np.ndarray:
    """List/array of ints -> (..., n) uint32 limb array (one to_bytes per
    element and one frombuffer, instead of a Python loop over limbs)."""
    xs = np.asarray(xs, dtype=object)
    flat = xs.reshape(-1)
    nbytes = 2 * n
    buf = b"".join(int(v).to_bytes(nbytes, "little") for v in flat)
    out = (
        np.frombuffer(buf, dtype="<u2")
        .reshape(flat.shape[0], n)
        .astype(np.uint32)
    )
    return out.reshape(xs.shape + (n,))


def array_to_ints(a) -> np.ndarray:
    """(..., n) limb array -> object array of Python ints (scalar if 1-D)."""
    a = np.asarray(a)
    shape = a.shape[:-1]
    flat = a.reshape(-1, a.shape[-1]).astype(np.uint16).astype("<u2")
    nbytes = 2 * flat.shape[1]
    buf = flat.tobytes()
    out = np.empty((flat.shape[0],), dtype=object)
    for i in range(flat.shape[0]):
        out[i] = int.from_bytes(buf[i * nbytes : (i + 1) * nbytes], "little")
    return out.reshape(shape) if shape else out[0]


def to_torch(a, device="cuda") -> torch.Tensor:
    """uint16/uint32 numpy limbs -> int32 tensor on `device` (same bits)."""
    a = np.ascontiguousarray(np.asarray(a).astype(np.uint32, copy=False))
    return torch.from_numpy(a.view(np.int32)).to(resolve_device(device))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 limb tensor -> uint32 numpy limbs (same bits)."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


# ------------------------------------------------------------- carry core


def _shift_up(a, d: int):
    """Along the last axis, limb k takes limb k-d (zeros in at the bottom)."""
    if d >= a.shape[-1]:
        return torch.zeros_like(a)
    z = torch.zeros(a.shape[:-1] + (d,), dtype=a.dtype, device=a.device)
    return torch.cat([z, a[..., :-d]], dim=-1)


def _resolve(t, gen, prop):
    """Kogge-Stone prefix over (generate, propagate) flags into each limb."""
    d = 1
    while d < t.shape[-1]:
        gen = gen | (prop & _shift_up(gen, d))
        prop = prop & _shift_up(prop, d)
        d *= 2
    return gen


def carry(acc, passes: int = 3):
    """Normalize int64 limbs to 16 bits, mod 2^(16·len).  Folding passes
    bring every limb to <= 2^16 (three for limbs below 2^40, one for limbs
    below 2^17), then a Kogge-Stone prefix resolves the +1 ripple.
    Callers guarantee the value fits."""
    t = acc
    for _ in range(passes):
        t = (t & MASK) + _shift_up(t >> W, 1)
    gen = _shift_up(t >> W, 1).bool()  # carry INTO limb k
    prop = _shift_up(t == MASK, 1)
    gen = _resolve(t, gen, prop)
    return (t + gen.to(t.dtype)) & MASK


def sub_raw(a, b):
    """a - b over 16-bit int64 limbs with Kogge-Stone borrow resolution;
    returns (diff limbs mod 2^(16·n), borrow_out bool)."""
    a, b = torch.broadcast_tensors(a, b)
    big = 1 << W
    d0 = a + big - b  # in [1, 2^17 - 1]
    top_g = (d0[..., -1] >> W) == 0
    gen = _shift_up((d0 >> W) == 0, 1)  # borrow INTO limb k
    prop = _shift_up(d0 == big, 1)
    gen = _resolve(d0, gen, prop)
    out = (d0 - gen.to(d0.dtype)) & MASK
    top_p = (d0[..., -1] == big) & gen[..., -1]
    return out, top_g | top_p


class LimbField:
    """Montgomery arithmetic mod `modulus` on (..., n) int32 limb tensors.

    Tensors may lie on the CPU or on a CUDA card; results stay where the
    inputs are.  Constants are built per device on first use."""

    def __init__(self, modulus: int, n_limbs: int, name: str = "F"):
        assert 2 * modulus < (1 << (W * n_limbs)), "need headroom for lazy sums"
        self.p = modulus
        self.n = n_limbs
        self.name = name
        self.R = 1 << (W * n_limbs)
        self.R_mod_p = self.R % modulus
        self.R2 = (self.R * self.R) % modulus
        self.p_inv_neg = (-pow(modulus, -1, self.R)) % self.R  # -p^-1 mod R
        self._consts = {}

    # ---------------- constants

    def _const(self, key: str, device) -> torch.Tensor:
        dev = torch.device(device)
        k = (key, str(dev))
        if k not in self._consts:
            vals = {
                "p": self.p,
                "pinv": self.p_inv_neg,
                "one_mont": self.R_mod_p,
                "one": 1,
                "r2": self.R2,
            }[key]
            self._consts[k] = to_torch(int_to_limbs(vals, self.n), dev)
        return self._consts[k]

    def const_mont(self, x: int, device="cuda") -> torch.Tensor:
        """Single constant in Montgomery form, shape (n,)."""
        v = (int(x) % self.p) * self.R_mod_p % self.p
        return to_torch(int_to_limbs(v, self.n), device)

    def zeros(self, shape=(), device="cuda") -> torch.Tensor:
        return torch.zeros(tuple(shape) + (self.n,), dtype=torch.int32,
                           device=resolve_device(device))

    def ones_mont(self, shape=(), device="cuda") -> torch.Tensor:
        one = self._const("one_mont", device)
        return one.expand(tuple(shape) + (self.n,)).contiguous()

    # ---------------- host <-> tensor conversion

    def encode(self, xs, mont: bool = True, device="cuda") -> torch.Tensor:
        """Python ints -> int32 limb tensor (optionally Montgomery form)."""
        scalar = np.isscalar(xs) or isinstance(xs, int)
        arr = np.asarray([xs] if scalar else xs, dtype=object)
        if mont:
            vals = [(int(v) % self.p) * self.R_mod_p % self.p
                    for v in arr.reshape(-1)]
        else:
            vals = [int(v) % self.p for v in arr.reshape(-1)]
        out = ints_to_array(vals, self.n).reshape(arr.shape + (self.n,))
        if scalar:
            out = out[0]
        return to_torch(out, device)

    def decode(self, a, mont: bool = True):
        """Limb tensor -> Python ints (object ndarray, or int if 1-D)."""
        a_np = to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)
        ints = array_to_ints(a_np)
        if not mont:
            return ints
        r_inv = pow(self.R_mod_p, -1, self.p)
        if np.ndim(ints) == 0 or isinstance(ints, int):
            return int(ints) * r_inv % self.p
        conv = np.empty(ints.shape, dtype=object)
        for idx, v in np.ndenumerate(ints):
            conv[idx] = int(v) * r_inv % self.p
        return conv

    # ---------------- plain int64 machinery (the CPU path)

    @staticmethod
    def _wide(a) -> torch.Tensor:
        return a.to(torch.int64)

    @staticmethod
    def _narrow(a) -> torch.Tensor:
        return a.to(torch.int32)

    def _p64(self, device):
        return self._wide(self._const("p", device))

    def _cond_sub_p(self, a):
        d, borrow = sub_raw(a, self._p64(a.device))
        return torch.where(borrow[..., None], a, d)

    def _add64(self, a, b):
        return self._cond_sub_p(carry(a + b, 1))

    def _sub64(self, a, b):
        d, borrow = sub_raw(a, b)
        dp = carry(d + self._p64(d.device), 1)
        return torch.where(borrow[..., None], dp, d)

    def mul_wide(self, a, b):
        """Full 2n-limb product of int64 n-limb values (normalized).
        Column sums stay < n·2^32 < 2^37, so one carry sweep suffices."""
        n = self.n
        a, b = torch.broadcast_tensors(a, b)
        cols = torch.zeros(a.shape[:-1] + (2 * n,), dtype=torch.int64,
                           device=a.device)
        for i in range(n):
            cols[..., i:i + n] += a[..., i:i + 1] * b
        return carry(cols)

    def _mul_low(self, a, b):
        """Low n limbs of a*b (mod R)."""
        n = self.n
        a, b = torch.broadcast_tensors(a, b)
        cols = torch.zeros(a.shape, dtype=torch.int64, device=a.device)
        for i in range(n):
            cols[..., i:] += a[..., i:i + 1] * b[..., : n - i]
        return carry(cols)

    def redc(self, t):
        """Montgomery reduction of int64 2n-limb t < p·R: t·R^-1 mod p."""
        n = self.n
        dev = t.device
        m = self._mul_low(t[..., :n], self._wide(self._const("pinv", dev)))
        mp = self.mul_wide(m, self._p64(dev))
        s = carry(t + mp, 1)  # low n limbs become zero; no carry-out
        return self._cond_sub_p(s[..., n:])

    # ---------------- ring ops (int32 in, int32 out)

    def add(self, a, b):
        return self._narrow(self._add64(self._wide(a), self._wide(b)))

    def sub(self, a, b):
        return self._narrow(self._sub64(self._wide(a), self._wide(b)))

    def neg(self, a):
        a64 = self._wide(a)
        d, _ = sub_raw(self._p64(a.device).expand(a64.shape), a64)
        return self._narrow(torch.where(self.is_zero(a)[..., None], a64, d))

    def mont_mul(self, a, b):
        """a·b·R^-1 mod p.  CUDA tensors: kernel K1; CPU tensors: plain."""
        from ..ops.field_kernel import mont_mul

        return mont_mul(self, a, b)

    def mont_sqr(self, a):
        return self.mont_mul(a, a)

    def to_mont(self, a):
        return self.mont_mul(a, self._const("r2", a.device))

    def from_mont(self, a):
        """a·R^-1 = REDC(a·1): one Montgomery multiply by the integer 1."""
        return self.mont_mul(a, self._const("one", a.device))

    # ---------------- predicates

    @staticmethod
    def is_zero(a):
        return (a == 0).all(dim=-1)

    @staticmethod
    def eq(a, b):
        return (a == b).all(dim=-1)

    @staticmethod
    def select(cond, a, b):
        """cond ? a : b  (cond has the batch shape, no limb axis)."""
        return torch.where(cond[..., None], a, b)

    # ---------------- exponentiation / inversion

    def pow_mont(self, a, e: int, mul=None):
        """a^e for a fixed Python-int exponent, 4-bit windows, each product
        `mul(x, y)` (default `mont_mul`).  A zero digit multiplies by
        nothing (x·1 is x in Montgomery form)."""
        mul = mul or self.mont_mul
        if e == 0:
            return self.ones_mont(a.shape[:-1], a.device)
        tbl = [None, a]
        for _ in range(14):
            tbl.append(mul(tbl[-1], a))
        digits = []
        x = e
        while x > 0:
            digits.append(x & 0xF)
            x >>= 4
        digits.reverse()
        acc = tbl[digits[0]]
        for dgt in digits[1:]:
            for _ in range(4):
                acc = mul(acc, acc)
            if dgt:
                acc = mul(acc, tbl[dgt])
        return acc

    def inv_mont(self, a):
        """Batched inversion via Fermat (a^(p-2)); inverse of 0 is 0.  On a
        CPU tensor the plain chain `pow_mont`; on a CUDA tensor of Fp one
        launch of the inversion kernel (`ops.field_kernel.mont_inv`), and
        of Fr the chain over kernel K1's multiply."""
        if self.name == "Fr" and a.device.type == "cuda":
            return self.pow_mont(a, self.p - 2)
        from ..ops.field_kernel import mont_inv

        return mont_inv(self, a)


# The two fields of BLS12-381.
FR_LIMBS = 16  # 256 bits
FP_LIMBS = 24  # 384 bits


@functools.cache
def fr_field() -> LimbField:
    return LimbField(FR_MODULUS, FR_LIMBS, "Fr")


@functools.cache
def fp_field() -> LimbField:
    return LimbField(FP_MODULUS, FP_LIMBS, "Fp")
