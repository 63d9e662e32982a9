"""Batched JubJub curve arithmetic and EdDSA verification (port of
`bazuka_tpu/ops/jubjub_batch.py`).

Extended twisted-Edwards coordinates (X, Y, Z, T) with a = -1 give a
complete, branch-free addition law (Hisil et al., "add-2008-hwcd-3"), so a
scalar multiply is a fixed 255-step loop of batched field ops with per-lane
bit selects and no data-dependent control flow.  Every multiply goes
through `LimbField.mont_mul` (kernel K1's Fr entry on a CUDA tensor);
results are bit-exact against the host curve (`crypto.jubjub`).

Layout: a batch of points is a tuple of four (B, 16) int32 limb tensors in
Montgomery form.  Scalars are standard-form (B, 16) limb tensors (bits are
read per 16-bit limb).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..crypto import jubjub as jj
from ..device import resolve_device
from ..fields.host import FR
from ..fields.limbs import LimbField, fr_field, to_numpy, to_torch
from .poseidon import _hash_fn


@functools.cache
def _consts(device):
    return {"k": fr_field().const_mont(2 * jj.D % jj.P, device)}  # k = 2d


def identity(F: LimbField, shape=(), device="cuda"):
    """Extended identity (0, 1, 1, 0)."""
    one = F.ones_mont(shape, device)
    return (F.zeros(shape, device), one, one, F.zeros(shape, device))


def to_extended(F: LimbField, x, y):
    """Affine Montgomery limbs -> extended (X, Y, Z, T)."""
    return (x, y, F.ones_mont(x.shape[:-1], x.device), F.mont_mul(x, y))


def to_affine_host(F: LimbField, P):
    """Extended point(s) -> affine ints (host side, one inversion each)."""
    xs, ys, zs = (F.decode(c) for c in P[:3])

    def conv(x, y, z):
        if z == 0:
            return (0, 1)
        zi = FR.inv(z)
        return (x * zi % jj.P, y * zi % jj.P)

    if np.ndim(xs) == 0:
        return conv(int(xs), int(ys), int(zs))
    out = np.empty(xs.shape, dtype=object)
    for idx in np.ndindex(xs.shape):
        out[idx] = conv(int(xs[idx]), int(ys[idx]), int(zs[idx]))
    return out


def ext_add(F: LimbField, P, Q):
    """Complete extended addition (add-2008-hwcd-3): nine multiplies, as two
    stacked (4, B, 16) multiplies and one by k = 2d.  Handles P == Q,
    P == -Q and identities with no branches."""
    k = _consts(P[0].device)["k"]
    X1, Y1, Z1, T1 = P
    X2, Y2, Z2, T2 = Q
    lhs = torch.stack(torch.broadcast_tensors(
        F.sub(Y1, X1), F.add(Y1, X1), T1, Z1))
    rhs = torch.stack(torch.broadcast_tensors(
        F.sub(Y2, X2), F.add(Y2, X2), T2, Z2))
    a, b, t1t2, z1z2 = F.mont_mul(lhs, rhs)
    c = F.mont_mul(k, t1t2)
    d = F.double(z1z2)
    e = F.sub(b, a)
    f = F.sub(d, c)
    g = F.add(d, c)
    h = F.add(b, a)
    out = F.mont_mul(torch.stack(torch.broadcast_tensors(e, g, f, e)),
                     torch.stack(torch.broadcast_tensors(f, h, g, h)))
    return tuple(out)


def ext_double(F: LimbField, P):
    """Doubling by the complete add."""
    return ext_add(F, P, P)


def ext_select(F: LimbField, cond, P, Q):
    """Per-lane select: cond ? P : Q (cond has the batch shape)."""
    return tuple(F.select(cond, p, q) for p, q in zip(P, Q))


def ext_eq(F: LimbField, P, Q):
    """Projective equality: X1·Z2 == X2·Z1 and Y1·Z2 == Y2·Z1."""
    X1, Y1, Z1, _ = P
    X2, Y2, Z2, _ = Q
    return torch.logical_and(
        F.eq(F.mont_mul(X1, Z2), F.mont_mul(X2, Z1)),
        F.eq(F.mont_mul(Y1, Z2), F.mont_mul(Y2, Z1)))


def _scalar_bit(scalars, i: int):
    """Bit i of standard-form 16-bit-limb scalars; shape = batch."""
    return ((scalars[..., i // 16] >> (i % 16)) & 1) != 0


def batch_scalar_mul(F: LimbField, points, scalars):
    """Variable-base double-and-add over bits 254..0: 255 fixed steps,
    branch-free.  points: extended tuple of (B, 16) Montgomery limbs;
    scalars: (B, 16) standard-form limbs."""
    acc = identity(F, scalars.shape[:-1], scalars.device)
    for i in range(254, -1, -1):
        acc = ext_double(F, acc)
        added = ext_add(F, acc, points)
        acc = ext_select(F, _scalar_bit(scalars, i), added, acc)
    return acc


@functools.cache
def _base_powers_np():
    """2^i·B for i in 0..254, extended Montgomery (X, Y, 1, X·Y), each a
    (255, 16) uint32 array: the JAX package's table limb for limb."""
    pts = []
    p = jj.BASE
    for _ in range(255):
        pts.append(p)
        p = jj.point_double(p)
    cols = ([q[0] for q in pts], [q[1] for q in pts], [1] * len(pts),
            [q[0] * q[1] for q in pts])
    return tuple(to_numpy(fr_field().encode(c, device="cpu")) for c in cols)


@functools.cache
def _base_powers(device):
    return tuple(to_torch(c, device) for c in _base_powers_np())


def batch_base_mul(F: LimbField, scalars):
    """Fixed-base s·B: 255 conditional adds of the table's 2^i·B."""
    tbl = _base_powers(scalars.device)
    acc = identity(F, scalars.shape[:-1], scalars.device)
    for i in range(255):
        added = ext_add(F, acc, tuple(c[i][None] for c in tbl))
        acc = ext_select(F, _scalar_bit(scalars, i), added, acc)
    return acc


# ---------------------------------------------------------------- EdDSA


@functools.cache
def _verify_fn(device):
    F = fr_field()
    poseidon6 = _hash_fn(6, device)

    def run(pk_x, pk_y, msg, r_x, r_y, s_std):
        """All (B, 16) limbs; pk, R and msg Montgomery, s standard form.
        Returns (B,) bool: s·B == R + h·A, h = Poseidon(R, A, msg)."""
        h_m = poseidon6(torch.stack([r_x, r_y, pk_x, pk_y, msg], dim=1))
        h_std = F.from_mont(h_m)
        sb = batch_base_mul(F, s_std)
        ha = batch_scalar_mul(F, to_extended(F, pk_x, pk_y), h_std)
        rhs = ext_add(F, ha, to_extended(F, r_x, r_y))
        return ext_eq(F, sb, rhs)

    return run


def batch_eddsa_verify(pks, msgs, sigs, device="cuda") -> np.ndarray:
    """Verify a batch of Poseidon-EdDSA signatures.

    pks: decompressed (x, y) int pairs; msgs: ints; sigs:
    `crypto.jubjub.Signature`s.  Returns a (B,) numpy bool array.  The
    on-curve checks of pk and R run on the host (reference
    src/crypto/jubjub/mod.rs:152-168)."""
    F = fr_field()
    dev = resolve_device(device)
    ok_curve = np.array([jj.is_on_curve(pk) and jj.is_on_curve(sig.r)
                         for pk, sig in zip(pks, sigs)], dtype=bool)

    def enc(vals, mont=True):
        return F.encode(np.array(vals, dtype=object), mont=mont, device=dev)

    ok = _verify_fn(dev)(
        enc([p[0] for p in pks]), enc([p[1] for p in pks]), enc(list(msgs)),
        enc([s.r[0] for s in sigs]), enc([s.r[1] for s in sigs]),
        enc([s.s for s in sigs], mont=False))
    return ok.cpu().numpy() & ok_curve
