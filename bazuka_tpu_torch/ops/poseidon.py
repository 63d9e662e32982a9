"""Batched Poseidon permutation (port of `bazuka_tpu/ops/poseidon.py`).

Hash-parallel, not round-parallel: a batch of B independent Poseidon-t
hashes is a (B, t, 16) int32 limb tensor in Montgomery form, and the round
schedule is a Python loop of batched field ops.  Every multiply (the S-box
x^5 and the dense MDS product) goes through `LimbField.mont_mul`, so on a
CUDA tensor each one is a launch of kernel K1's Fr entry; the adds are the
limb engine's plain PyTorch path.  This is the batch behind whole levels of
the 4-ary state tree (one hash per node of a level at once).

Bit-exact against the host Poseidon (`zk/poseidon_host.py`) and the
reference's 16 golden vectors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve_device
from ..fields.limbs import LimbField, fr_field, to_numpy, to_torch
from ..zk.poseidon_host import params_for_width


@functools.cache
def _mont_params(t: int):
    """(params, round constants (n_rounds, t, 16), MDS (t, t, 16)): uint32
    Montgomery limbs, the JAX package's tables limb for limb."""
    F = fr_field()
    p = params_for_width(t)
    rc = to_numpy(F.encode(p.round_constants, device="cpu")).reshape(
        p.full_rounds + p.partial_rounds, t, F.n)
    mds = to_numpy(F.encode(p.mds, device="cpu"))
    return p, rc, mds


def _permute(F: LimbField, state, rc, mds, full_rounds: int,
             partial_rounds: int, mul):
    """state: (B, t, 16) Montgomery limbs -> the permuted state; every
    product is `mul(a, b)`."""
    t = state.shape[-2]

    def sbox(x):
        x2 = mul(x, x)
        x4 = mul(x2, x2)
        return mul(x4, x)

    def mds_mul(s):
        # out[b, j] = sum_k mds[j, k] * s[b, k]: one broadcast multiply over
        # the whole (B, t, t) lattice, then t - 1 field adds
        prod = mul(mds[None], s[:, None])  # (B, t, t, 16)
        acc = prod[:, :, 0]
        for k in range(1, t):
            acc = F.add(acc, prod[:, :, k])
        return acc

    half = full_rounds // 2
    for r in range(full_rounds + partial_rounds):
        state = F.add(state, rc[r][None])
        if half <= r < half + partial_rounds:
            state = torch.cat([sbox(state[:, :1]), state[:, 1:]], dim=1)
        else:
            state = sbox(state)
        state = mds_mul(state)
    return state


@functools.cache
def _hash_fn(t: int, device):
    """The Poseidon-t hash of (B, t - 1, 16) Montgomery limbs on `device`:
    a zero capacity lane is prepended, and lane 1 of the permuted state is
    the (B, 16) hash."""
    p, rc_np, mds_np = _mont_params(t)
    F = fr_field()
    rc = to_torch(rc_np, device)
    mds = to_torch(mds_np, device)

    def run(inputs, mul=None):
        cap = torch.zeros_like(inputs[:, :1])
        state = torch.cat([cap, inputs], dim=1)
        out = _permute(F, state, rc, mds, p.full_rounds, p.partial_rounds,
                       mul or F.mont_mul)
        return out[:, 1]

    return run


def poseidon_batch_mont(inputs: torch.Tensor, mul=None) -> torch.Tensor:
    """Hash a batch: (B, arity, 16) int32 Montgomery limbs -> (B, 16), on
    the inputs' device.  Every product is `mul(a, b)`, by default
    `LimbField.mont_mul` (kernel K1 on a CUDA tensor); a check passes the
    plain multiply to run the plain version on the card."""
    return _hash_fn(inputs.shape[1] + 1, inputs.device)(inputs, mul)


def poseidon_batch(values, device="cuda") -> np.ndarray:
    """A (B, arity) array of Python ints -> (B,) object array of hashes."""
    F = fr_field()
    dev = resolve_device(device)
    enc = F.encode(np.asarray(values, dtype=object), device=dev)
    return F.decode(poseidon_batch_mont(enc))
