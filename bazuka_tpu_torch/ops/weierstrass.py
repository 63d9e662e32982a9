"""Branch-free short-Weierstrass point arithmetic for BLS12-381 G1/G2
(port of `bazuka_tpu/ops/weierstrass.py`).

The complete projective addition law for a = 0 curves (Renes-Costello-
Batina 2015, algorithm 7) handles doubling, identity and inverses with one
12-multiply formula.  `FpOps` runs it over Fp (24x16-bit limbs), `Fp2Ops`
over Fp2 = Fp[u]/(u^2+1) as coordinate pairs, so the same code serves G1
and G2 (b = 4 resp. 4(u+1)).  Points are (X, Y, Z) tuples of (B, 24) int32
Montgomery limb tensors; identity is (0, 1, 0).

`plain=True` field adapters multiply with the plain Montgomery multiply even
on the card: they are the reference the curve kernels are held against.
With the default adapters, `proj_add` on CUDA tensors runs the whole
formula in one kernel (K6 on G1, K7 on G2, `ops.curve_kernels`, CUDA
source `csrc/add_select.cu`), at every batch size, as the JAX package
routes it to `ops/pallas_curve.py` on a TPU.

The fixed-base multiply `batch_gen_mul` (keygen's workhorse) adds one entry
of a window table per 8-bit window of the scalar: 32 complete adds.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..crypto import bls12_381 as bls
from ..fields import tower as tw
from ..fields.host import FP_MODULUS
from ..fields.limbs import FR_LIMBS, fp_field, fr_field
from .field_kernel import mont_mul_plain


class FpOps:
    """Field adapter over Fp limbs.  Elements: (B, 24) int32 Montgomery."""

    def __init__(self, plain: bool = False):
        self.F = fp_field()
        self.plain = plain

    def add(self, a, b):
        return self.F.add(a, b)

    def sub(self, a, b):
        return self.F.sub(a, b)

    def mul(self, a, b):
        if self.plain:
            return mont_mul_plain(self.F, a, b)
        return self.F.mont_mul(a, b)

    def select(self, cond, a, b):
        return self.F.select(cond, a, b)

    def zero(self, shape, device):
        return self.F.zeros(shape, device)

    def one(self, shape, device):
        return self.F.ones_mont(shape, device)

    def encode(self, ints, device):
        return self.F.encode(np.array(ints, dtype=object), device=device)

    def stack(self, elems):
        """Stack field elements along a new leading axis, so that several
        independent multiplies run as one call."""
        return torch.stack(torch.broadcast_tensors(*elems), dim=0)

    def unstack(self, a, k: int):
        return [a[i] for i in range(k)]

    def bcast(self, e, like):
        return e.expand(like.shape)


class Fp2Ops:
    """Field adapter over Fp2: elements are (c0, c1) pairs of Fp limb
    tensors; Karatsuba multiply with the three Fp products in one call."""

    def __init__(self, plain: bool = False):
        self.F = fp_field()
        self.plain = plain

    def add(self, a, b):
        return (self.F.add(a[0], b[0]), self.F.add(a[1], b[1]))

    def sub(self, a, b):
        return (self.F.sub(a[0], b[0]), self.F.sub(a[1], b[1]))

    def mul(self, a, b):
        F = self.F
        lhs = torch.stack(torch.broadcast_tensors(a[0], a[1], F.add(a[0], a[1])))
        rhs = torch.stack(torch.broadcast_tensors(b[0], b[1], F.add(b[0], b[1])))
        t = mont_mul_plain(F, lhs, rhs) if self.plain else F.mont_mul(lhs, rhs)
        t0, t1, t2 = t[0], t[1], t[2]
        return (F.sub(t0, t1), F.sub(F.sub(t2, t0), t1))

    def select(self, cond, a, b):
        return (self.F.select(cond, a[0], b[0]), self.F.select(cond, a[1], b[1]))

    def zero(self, shape, device):
        return (self.F.zeros(shape, device), self.F.zeros(shape, device))

    def one(self, shape, device):
        return (self.F.ones_mont(shape, device), self.F.zeros(shape, device))

    def encode(self, pairs, device):
        return tuple(self.F.encode(np.array([p[k] for p in pairs], dtype=object),
                                   device=device) for k in range(2))

    def stack(self, elems):
        c0 = torch.stack(torch.broadcast_tensors(*[e[0] for e in elems]))
        c1 = torch.stack(torch.broadcast_tensors(*[e[1] for e in elems]))
        return (c0, c1)

    def unstack(self, a, k: int):
        return [(a[0][i], a[1][i]) for i in range(k)]

    def bcast(self, e, like):
        return (e[0].expand(like[0].shape), e[1].expand(like[1].shape))


@functools.cache
def fp_ops(plain: bool = False) -> FpOps:
    return FpOps(plain)


@functools.cache
def fp2_ops(plain: bool = False) -> Fp2Ops:
    return Fp2Ops(plain)


# ---------------------------------------------------------------- curve

G1_B3 = 12
G2_B3 = (12, 12)  # 3 * 4(u+1) = 12 + 12u


def g1_b3(device):
    return fp_field().const_mont(G1_B3, device)


def g2_b3(device):
    F = fp_field()
    return (F.const_mont(G2_B3[0], device), F.const_mont(G2_B3[1], device))


def proj_identity(K, shape, device):
    return (K.zero(shape, device), K.one(shape, device), K.zero(shape, device))


def _kernel_add(K, P, Q):
    """P + Q in kernel K6 (G1) or K7 (G2): the coordinates broadcast to one
    batch shape, flattened to limb-major lanes and back."""
    from . import curve_kernels as ck

    g2 = isinstance(K, Fp2Ops)
    comps = [c for coord in (*P, *Q) for c in (coord if g2 else (coord,))]
    comps = torch.broadcast_tensors(*comps)
    shape = comps[0].shape
    lm = [c.reshape(-1, shape[-1]).T for c in comps]
    half = len(lm) // 2
    p = torch.stack(lm[:half]).contiguous()
    q = torch.stack(lm[half:]).contiguous()
    out = (ck.g2_add_lm if g2 else ck.g1_add_lm)(p, q)
    o = [out[i].T.reshape(shape) for i in range(half)]
    if g2:
        return tuple((o[2 * i], o[2 * i + 1]) for i in range(3))
    return tuple(o)


def proj_add(K, P, Q, b3):
    """Complete addition, RCB15 algorithm 7 (a = 0), b3 = 3*b as a field
    constant.  On CUDA tensors with the default adapters, one K6/K7 launch;
    otherwise the 12 multiplies run as 3 stacked calls by dependency
    level."""
    X = P[0][0] if isinstance(K, Fp2Ops) else P[0]
    if not K.plain and X.device.type == "cuda":
        return _kernel_add(K, P, Q)
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    lhs = K.stack([X1, Y1, Z1, K.add(X1, Y1), K.add(Y1, Z1), K.add(X1, Z1)])
    rhs = K.stack([X2, Y2, Z2, K.add(X2, Y2), K.add(Y2, Z2), K.add(X2, Z2)])
    t0, t1, t2, u, v, w = K.unstack(K.mul(lhs, rhs), 6)
    t3 = K.sub(u, K.add(t0, t1))
    t4 = K.sub(v, K.add(t1, t2))
    Y3 = K.sub(w, K.add(t0, t2))
    X3 = K.add(K.add(t0, t0), t0)  # 3*X1*X2
    t2b, Y3b = K.unstack(
        K.mul(K.stack([t2, Y3]), K.stack([K.bcast(b3, t2), K.bcast(b3, Y3)])), 2
    )
    Z3 = K.add(t1, t2b)
    t1m = K.sub(t1, t2b)
    p = K.mul(
        K.stack([t3, t4, Y3b, t1m, Z3, X3]),
        K.stack([t1m, Y3b, X3, Z3, t4, t3]),
    )
    p1, p2, p3, p4, p5, p6 = K.unstack(p, 6)
    return (K.sub(p1, p2), K.add(p3, p4), K.add(p5, p6))


def proj_double(K, P, b3):
    return proj_add(K, P, P, b3)


def proj_select(K, cond, P, Q):
    return tuple(K.select(cond, p, q) for p, q in zip(P, Q))


def _scalar_bit(scalars, i: int):
    """Bit i of standard-form 16-bit-limb scalars (batch shape out)."""
    return ((scalars[..., i // 16] >> (i % 16)) & 1) != 0


def proj_scalar_mul(K, P, scalars, b3, nbits: int = 255):
    """Branch-free double-and-add over a fixed nbits rounds.
    scalars: (B, 16) standard-form Fr limbs."""
    if scalars.shape[-1] != FR_LIMBS:
        raise ValueError(f"scalars must hold {FR_LIMBS} limbs")
    acc = proj_identity(K, scalars.shape[:-1], scalars.device)
    for j in range(nbits):
        acc = proj_double(K, acc, b3)
        added = proj_add(K, acc, P, b3)
        acc = proj_select(K, _scalar_bit(scalars, nbits - 1 - j), added, acc)
    return acc


# ------------------------------------------------- projective -> affine


def g1_proj_to_am(P):
    """Projective (X, Y, Z) (N, 24) Montgomery limbs -> point-major affine
    ((N, 2, 24) limbs, (N,) bool infinity mask).  One batched Fermat
    inversion z^(p-2) (0 -> 0), as `bazuka_tpu`'s `_fermat_inv_fn`: one
    launch of kernel K1's Fp inversion entry on the card."""
    F = fp_field()
    X, Y, Z = P
    zinv = F.inv_mont(Z)
    x = F.mont_mul(X, zinv)
    y = F.mont_mul(Y, zinv)
    inf = (Z == 0).all(dim=-1)
    return torch.stack([x, y], dim=1), inf


def g2_proj_to_am(P):
    """Projective G2 ((X0,X1),(Y0,Y1),(Z0,Z1)) (N, 24) Montgomery limbs ->
    point-major affine ((N, 4, 24), (N,) bool inf mask).  The Fp2
    inverse is one Fp inversion of the norm:
    (z0 + z1·i)^-1 = (z0 − z1·i) / (z0² + z1²)."""
    F = fp_field()
    (X0, X1), (Y0, Y1), (Z0, Z1) = P
    norm = F.add(F.mont_mul(Z0, Z0), F.mont_mul(Z1, Z1))
    ninv = F.inv_mont(norm)
    zi0 = F.mont_mul(Z0, ninv)
    zi1 = F.mont_mul(F.neg(Z1), ninv)

    def f2mul(a0, a1, b0, b1):
        t0 = F.mont_mul(a0, b0)
        t1 = F.mont_mul(a1, b1)
        t2 = F.mont_mul(F.add(a0, a1), F.add(b0, b1))
        return F.sub(t0, t1), F.sub(F.sub(t2, t0), t1)

    x0, x1 = f2mul(X0, X1, zi0, zi1)
    y0, y1 = f2mul(Y0, Y1, zi0, zi1)
    inf = (Z0 == 0).all(dim=-1) & (Z1 == 0).all(dim=-1)
    return torch.stack([x0, x1, y0, y1], dim=1), inf


# ------------------------------------------------- host <-> limb points


def g1_to_proj(pts, device):
    """List of host affine G1 points ((x, y) or None) -> projective limbs."""
    K = fp_ops()
    return (K.encode([p[0] if p else 0 for p in pts], device),
            K.encode([p[1] if p else 1 for p in pts], device),
            K.encode([0 if p is None else 1 for p in pts], device))


def g2_to_proj(pts, device):
    """List of host affine G2 points (((x0,x1),(y0,y1)) or None) ->
    projective limbs."""
    K = fp2_ops()
    return (K.encode([p[0] if p else (0, 0) for p in pts], device),
            K.encode([p[1] if p else (1, 0) for p in pts], device),
            K.encode([(0, 0) if p is None else (1, 0) for p in pts], device))


def g1_from_proj(P):
    """Projective limb tensors -> list of host affine points / None."""
    F = fp_field()
    xs, ys, zs = (np.atleast_1d(F.decode(c)) for c in P)
    out = []
    for x, y, z in zip(xs, ys, zs):
        if int(z) == 0:
            out.append(None)
        else:
            zi = pow(int(z), -1, FP_MODULUS)
            out.append((int(x) * zi % FP_MODULUS, int(y) * zi % FP_MODULUS))
    return out


def g2_from_proj(P):
    """Projective G2 limb tensors -> list of host affine points / None."""
    F = fp_field()
    dec = [(np.atleast_1d(F.decode(c[0])), np.atleast_1d(F.decode(c[1])))
           for c in P]
    out = []
    for i in range(len(dec[0][0])):
        x, y, z = ((int(d[0][i]), int(d[1][i])) for d in dec)
        if z == (0, 0):
            out.append(None)
        else:
            zi = tw.fp2_inv(z)
            out.append((tw.fp2_mul(x, zi), tw.fp2_mul(y, zi)))
    return out


# ---------------------------------------------------------------- fixed base


@functools.cache
def _gen_powers_host(kind: str):
    """Host table [2^i * GEN for i in 0..254] (affine)."""
    p = bls.G1_GEN if kind == "g1" else bls.G2_GEN
    dbl = bls.g1_double if kind == "g1" else (lambda q: bls.g2_add(q, q))
    pts = []
    for _ in range(255):
        pts.append(p)
        p = dbl(p)
    return pts


@functools.cache
def gen_powers(kind: str, device: str):
    """Table of generator powers 2^i * GEN as projective limbs (255 rows)."""
    to_proj = g1_to_proj if kind == "g1" else g2_to_proj
    return to_proj(_gen_powers_host(kind), device)


GEN_WINDOW_C = 8  # fixed-base window bits: 32 table adds per scalar
_N_WINDOWS = (255 + GEN_WINDOW_C - 1) // GEN_WINDOW_C


def _curve(kind: str, device):
    if kind == "g1":
        return fp_ops(), g1_b3(device)
    return fp2_ops(), g2_b3(device)


def _gather(P, idx):
    """Rows idx of a projective point tensor tuple (G1 or G2)."""
    return tuple((c[0][idx], c[1][idx]) if isinstance(c, tuple) else c[idx]
                 for c in P)


@functools.cache
def _gen_window_table(kind: str, device: str):
    """Projective table T[w*256 + d] = d * 2^(8w) * GEN for the windowed
    fixed-base multiply, kept per device for the life of the process.

    The JAX package builds it with 8 conditional-add passes over all
    32*256 lanes: pass i adds 2^(8w+i) * GEN where bit i of d is set.  Here
    pass i computes only the digits whose top set bit is i, as
    T[w, d + 2^i] = T[w, d] + 2^(8w+i) * GEN for d < 2^i, from the entries
    already built: each entry is the same chain of complete adds on the
    same inputs, so the table is the JAX table limb for limb, in 8160
    adds instead of 65536 (32 * 2^i lanes in pass i).  As in the JAX
    package, the top window's power index is clamped to 254: Fr scalars are
    below 2^255, so its entries for digits >= 128 are never gathered."""
    K, b3 = _curve(kind, device)
    powers = gen_powers(kind, device)
    c = GEN_WINDOW_C
    tbl = proj_identity(K, (_N_WINDOWS, 1), device)
    for i in range(c):
        idx = np.minimum(np.arange(_N_WINDOWS) * c + i, 254)
        step = _gather(powers, torch.from_numpy(idx).to(device)[:, None])
        new = proj_add(K, tbl, step, b3)
        tbl = tuple(
            tuple(torch.cat([t[k], n[k]], dim=1) for k in range(2))
            if isinstance(t, tuple) else torch.cat([t, n], dim=1)
            for t, n in zip(tbl, new))
    lanes = _N_WINDOWS << c
    return tuple(
        tuple(t[k].reshape(lanes, -1) for k in range(2))
        if isinstance(t, tuple) else t.reshape(lanes, -1)
        for t in tbl)


def batch_gen_mul(scalars, kind: str = "g1"):
    """Batched fixed-base multiply s_i * GEN (keygen's workhorse).
    scalars: (B, 16) standard-form Fr limbs -> (B,) projective points:
    32 windowed table-gather adds per scalar."""
    device = scalars.device
    K, b3 = _curve(kind, device)
    tbl = _gen_window_table(kind, str(device))
    c = GEN_WINDOW_C
    per_limb = 16 // c
    acc = proj_identity(K, scalars.shape[:-1], device)
    for w in range(_N_WINDOWS):
        digit = ((scalars[..., w // per_limb] >> ((w % per_limb) * c))
                 & ((1 << c) - 1)).to(torch.int64) + (w << c)
        acc = proj_add(K, acc, _gather(tbl, digit), b3)
    return acc


def batch_gen_mul_host(scalars, kind: str = "g1", device="cuda"):
    """Host ints in -> host affine points out."""
    Fr = fr_field()
    s = Fr.encode(np.array(list(scalars), dtype=object), mont=False,
                  device=device)
    R = batch_gen_mul(s, kind)
    return g1_from_proj(R) if kind == "g1" else g2_from_proj(R)
