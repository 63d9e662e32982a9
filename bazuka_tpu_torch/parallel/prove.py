"""One Groth16 proof over a mesh of shards (port of
`bazuka_tpu/parallel/prove.py`).

  * Every MSM (4 G1, 1 G2) runs the v3 drain (`ops.msm_lm._msm_v3`) per
    shard over a contiguous range of the query's rows.  Bucket sums add
    over point subsets, so each shard's window sums are partial results;
    they are gathered on shard 0's device, folded into lanes and
    tree-reduced there by log2(D) levels of the projective add-with-select
    kernels K3/K5 (the curve group's psum).  The W-window double-and-add
    is the host's (`msm_lm._combine`).
  * The h phase runs every transform on the four-step
    (`parallel.ntt_four_step`, three exchanges per transform); the coset
    scales and pointwise products run per shard (K1).
  * Duplicate-heavy witness scalars reuse the single-device dedup plan:
    the heavy groups are presummed from the heavy rows alone (gathered on
    the host for a host query, `_presum_from_host`), finished in a small
    MSM on shard 0's device, and the sharded drain sees those rows'
    scalars zeroed (`msm_lm.dedup_split`).

The proof's stages are `groth16.prove.prove_with`'s, as for one device:
this module hands it the three steps that differ (the h phase, placing a
query's rows on the shards, the sharded drain).  Witness encode and the
sparse row evaluation run on shard 0's device, as the JAX package runs
them replicated.  The shards run one after another:
each drain waits on the host for its data-dependent scan steps.  The JAX
package's sharded prover has no big mode, and neither has this one.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..crypto import bls12_381 as bls
from ..fields.host import FR_GENERATOR, FR_MODULUS
from ..fields.limbs import (fr_field, narrow_to_device, to_torch, widen_flags,
                            widen_limbs)
from ..groth16 import prove as single
from ..groth16.keygen import Parameters
from ..groth16.r1cs import ConstraintSystem
from ..ops import curve_kernels as ck
from ..ops import msm_lm as msm
from ..ops import ntt as ntt_mod
from ..zk.proof import Groth16Proof
from . import Mesh, _blocks, gather_rows, ntt_four_step, synchronize

P = FR_MODULUS


# ------------------------------------------------------------ sharded MSM


def _reduce_parts(parts: List[torch.Tensor], kind: str, device):
    """The shards' (n_proj, 24, W) projective window sums -> their sum
    (n_proj, 24, W) on `device`: gathered there and folded into lanes
    (shard d's window w in lane d·W + w), then log2(D) levels of K3/K5
    with every lane active, each adding the upper half of the blocks to
    the lower; an odd level carries its unpaired block through.  The
    lanes are not padded (the kernels guard their last block)."""
    addsel = ck.add_select_lm if kind == "g1" else ck.add_select_g2_lm
    W = parts[0].shape[2]
    acc = torch.cat([p.to(device) for p in parts], dim=2)
    m = len(parts)
    while m > 1:
        half = m // 2
        lo = acc[:, :, :half * W].contiguous()
        hi = acc[:, :, half * W:2 * half * W].contiguous()
        ones = torch.ones(half * W, dtype=torch.bool, device=device)
        out = addsel(lo, hi, ones)
        if m % 2:
            out = torch.cat([out, acc[:, :, (m - 1) * W:]], dim=2)
        acc = out
        m -= half
    return acc


def _presum_from_host(query, plan, kind: str, device):
    """The heavy groups' affine sums from a host query: only its
    n_heavy_elems heavy rows are gathered (numpy fancy index) and uploaded
    narrow to `device`, and presummed there at rows 0, 1, ... : the whole
    query never lands on one device."""
    am, inf = query
    heavy = (narrow_to_device(am[plan.hpos], device),
             narrow_to_device(inf[plan.hpos], device))
    pres = msm.presum_g1 if kind == "g1" else msm.presum_g2_am
    return pres(*heavy, plan, rows=np.arange(plan.n_heavy_elems))


def _place(mesh: Mesh, query):
    """(the query, [shard i's rows of it on mesh[i]]): a host query's rows
    uploaded narrow, a tensor's moved as they are; `_msm_placed` takes
    the pair."""
    am, inf = query
    n = int(am.shape[0]) // len(mesh)
    move = (narrow_to_device if isinstance(am, np.ndarray)
            else lambda t, dev: t.to(dev))
    return query, [(move(am[i * n:(i + 1) * n], dev),
                    move(inf[i * n:(i + 1) * n], dev))
                   for i, dev in enumerate(mesh)]


def _msm_placed(mesh: Mesh, placed, scalars_std, kind: str, c: int,
                nbits: int, chunk: int, plan):
    """`msm_sharded_v3` over a query already placed (`_place`).  The
    shards' parts are dropped from the list as each is widened."""
    dev0 = mesh[0]
    query, parts = placed

    def presum():
        if isinstance(query[0], np.ndarray):
            return _presum_from_host(query, plan, kind, dev0)
        pres = msm.presum_g1 if kind == "g1" else msm.presum_g2_am
        return tuple(t.to(dev0) for t in pres(*query, plan))

    extra, scalars_std = msm.dedup_split(kind, plan, presum, scalars_std,
                                         nbits, chunk)
    n = int(scalars_std.shape[0]) // len(mesh)
    wins = []
    for i, dev in enumerate(mesh):
        P_i, inf_i = widen_limbs(parts[i][0]), widen_flags(parts[i][1])
        parts[i] = None  # a narrow part goes once it is widened
        wins.append(msm._msm_v3(P_i, inf_i,
                                scalars_std[i * n:(i + 1) * n].to(dev),
                                c, nbits, chunk, kind))
        del P_i, inf_i
    main = msm._combine(kind, _reduce_parts(wins, kind, dev0), c)
    return (bls.g1_add if kind == "g1" else bls.g2_add)(main, extra)


def msm_sharded_v3(mesh: Mesh, query, scalars_std, kind: str = "g1",
                   c: int = 12, nbits: int = 255, chunk: int = 1 << 18,
                   dedup_plan=None):
    """The v3 drain per shard over its range of rows, the shards' window
    sums tree-reduced on shard 0's device (`_reduce_parts`).

    query: ((N, a, 24) affine limbs, (N,) infinity flags), wide or narrow,
    as host numpy arrays (uploaded narrow, a shard's rows at a time) or
    tensors on any device (each shard's rows moved to it); N must divide
    by the mesh's size.  scalars_std: (N, 16) standard-form Fr limbs
    (numpy, a tensor, or a tensor in a one-element list, as for
    `msm_lm`).  With an active dedup plan the heavy groups' presum runs
    where the query is (a host query's on shard 0's device) and their
    small MSM on shard 0's device (`msm_lm.dedup_split`); the drain sees
    their scalars zeroed.  Returns a host affine point (None for the zero
    sum)."""
    N = int(query[0].shape[0])
    if N % len(mesh):
        raise ValueError(f"pad the MSM length ({N}) to the mesh size "
                         f"({len(mesh)})")
    if isinstance(scalars_std, np.ndarray):
        scalars_std = to_torch(scalars_std, mesh[0])
    return _msm_placed(mesh, _place(mesh, query), scalars_std, kind, c,
                       nbits, chunk, dedup_plan)


# -------------------------------------------------------- sharded h phase


def _coset_rows(log_n: int, inverse: bool, lo: int, m: int, device):
    """Rows [lo, lo + m) of `ops.ntt._coset_scale(log_n, inverse)`: the
    Montgomery g^i (g^-i), built on `device` (`ops.ntt._pow_table`)."""
    g = FR_GENERATOR if not inverse else pow(FR_GENERATOR, -1, P)
    e = torch.arange(lo, lo + m, dtype=torch.int64, device=device)
    return ntt_mod._pow_table(e, g, log_n)


def _scale_blocks(blocks, inverse: bool):
    """Each row block times its rows of the coset scale (K1, per shard)."""
    F = fr_field()
    m = int(blocks[0].shape[0])
    log_n = ntt_mod._log2(m * len(blocks))
    return [F.mont_mul(b, _coset_rows(log_n, inverse, i * m, m, b.device))
            for i, b in enumerate(blocks)]


def coset_ntt_fs(mesh: Mesh, x) -> List[torch.Tensor]:
    """Coset evaluation on the mesh: the g^i pre-scale per shard, then
    `ntt_four_step`.  Takes and returns row blocks (or a whole tensor in)."""
    return ntt_four_step(mesh, _scale_blocks(_blocks(x, mesh), False))


def coset_intt_fs(mesh: Mesh, x) -> List[torch.Tensor]:
    """Coset interpolation: `ntt_four_step` inverse, then the g^-i
    post-scale per shard."""
    return _scale_blocks(ntt_four_step(mesh, x, inverse=True), True)


def _mesh_fits_fourstep(d: int, D: int) -> bool:
    """Whether the four-step's factors of a 2^k domain d divide over D
    shards."""
    log_n = d.bit_length() - 1
    log_c = log_n // 2
    return (d >= 2 and (1 << log_c) % D == 0
            and (1 << (log_n - log_c)) % D == 0)


def compute_h_sharded(mesh: Mesh, evs: list, d: int) -> torch.Tensor:
    """`groth16.prove.compute_h_mont` over the mesh: [ea, eb, ec] (d, 16)
    Montgomery row evaluations -> h(x)'s d - 1 standard-form coefficients
    on shard 0's device, every transform the four-step.  Domains too
    small for the mesh's factorization (d < D²) run `compute_h_mont` on
    shard 0 instead: only toy sizes reach it.  Pops each input as it is
    transformed."""
    F = fr_field()
    dev0 = mesh[0]
    if not _mesh_fits_fourstep(d, len(mesh)):
        return single.compute_h_mont([e.to(dev0) for e in evs], d)

    def coset(x):
        return coset_ntt_fs(mesh, ntt_four_step(mesh, x, inverse=True))

    assert len(evs) == 3
    ca = coset(evs.pop(0))
    cb = coset(evs.pop(0))
    ab = [F.mont_mul(a, b) for a, b in zip(ca, cb)]
    del ca, cb
    cc = coset(evs.pop(0))
    z_on_coset = (pow(FR_GENERATOR, d, P) - 1) % P
    zinv = pow(z_on_coset, -1, P)
    h_evals = [F.mont_mul(F.sub(a, c), F.const_mont(zinv, a.device)[None])
               for a, c in zip(ab, cc)]
    del ab, cc
    h = [F.from_mont(b) for b in coset_intt_fs(mesh, h_evals)]
    del h_evals
    return gather_rows(h, dev0)[: d - 1]


# ------------------------------------------------------ sharded prover


def create_proof_sharded(params: Parameters, cs: ConstraintSystem, mesh: Mesh,
                         r: Optional[int] = None, s: Optional[int] = None,
                         record: Optional[dict] = None) -> Groth16Proof:
    """`groth16.prove.create_proof` over the mesh: the same stages
    (`groth16.prove.prove_with`) and wire bytes, with the h phase on
    `compute_h_sharded` and each MSM's query placed a shard's rows per
    device and drained there (`msm_sharded_v3`'s steps).  Witness encode,
    row evaluation and the dedup plans run on shard 0's device; the key's
    queries may lie on a card or on the host.  Np must divide by the
    mesh's size; there is no big mode.  `record` is as for `create_proof`
    (the cards synchronised at each stage boundary), with the mesh's
    devices under "shards"."""
    Np = params.pk.a_query[0].shape[0]
    if Np % len(mesh):
        raise ValueError(f"the mesh ({len(mesh)} shards) must divide the "
                         f"key's length Np = {Np}")

    def run_msm(kind, placed, box, plan, c, big):
        return _msm_placed(mesh, placed, box, kind, c, 255, 1 << 18, plan)

    proof = single.prove_with(
        params, cs, mesh[0], r, s, record, lambda: synchronize(mesh),
        lambda evs, d: compute_h_sharded(mesh, evs, d),
        lambda query: _place(mesh, query), run_msm)
    if record is not None:
        record["shards"] = [str(x) for x in mesh]
    return proof
