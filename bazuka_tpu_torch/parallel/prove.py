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
    scalars zeroed.

Witness encode and the sparse row evaluation run on shard 0's device, as
the JAX package runs them replicated.  The shards run one after another:
each drain waits on the host for its data-dependent scan steps.  The JAX
package's sharded prover has no big mode, and neither has this one.
"""

from __future__ import annotations

import secrets
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from ..crypto import bls12_381 as bls
from ..fields.host import FR_GENERATOR, FR_MODULUS
from ..fields.limbs import fr_field, ints_to_array, narrow_to_device, to_torch
from ..groth16 import prove as single
from ..groth16 import qap
from ..groth16.keygen import Parameters
from ..groth16.r1cs import ConstraintSystem, SynthesisError
from ..groth16.sparse import DeviceR1CS
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


def _shard_query(query, lo: int, hi: int, device):
    """Rows [lo, hi) of a query on `device`: a host query's uploaded
    narrow, a tensor's moved as they are."""
    am, inf = query
    if isinstance(am, np.ndarray):
        return (narrow_to_device(am[lo:hi], device),
                narrow_to_device(inf[lo:hi], device))
    return am[lo:hi].to(device), inf[lo:hi].to(device)


def msm_sharded_v3(mesh: Mesh, query, scalars_std, kind: str = "g1",
                   c: int = 12, nbits: int = 255, chunk: int = 1 << 18,
                   dedup_plan=None, record: Optional[dict] = None):
    """The v3 drain per shard over its range of rows, the shards' window
    sums tree-reduced on shard 0's device (`_reduce_parts`).

    query: ((N, a, 24) affine limbs, (N,) infinity flags), wide or narrow,
    as host numpy arrays (uploaded narrow, a shard's rows at a time) or
    tensors on any device (each shard's rows moved to it); N must divide
    by the mesh's size.  scalars_std: (N, 16) standard-form Fr limbs
    (numpy or a tensor).  With an active dedup plan the heavy groups'
    presum runs where the query is (a host query's on shard 0's device)
    and their small MSM on shard 0's device; the drain sees their
    scalars zeroed.  If `record` is a dict, a host query's upload seconds
    (the cards synchronised) go to its "upload_s".  Returns a host affine
    point (None for the zero sum)."""
    D = len(mesh)
    dev0 = mesh[0]
    am, inf = query
    N = int(am.shape[0])
    if N % D:
        raise ValueError(f"pad the MSM length ({N}) to the mesh size ({D})")
    host = isinstance(am, np.ndarray)
    if isinstance(scalars_std, np.ndarray):
        scalars_std = to_torch(scalars_std, dev0)
    add = bls.g1_add if kind == "g1" else bls.g2_add
    extra = None
    if dedup_plan is not None and dedup_plan.active:
        plan = dedup_plan
        if host:
            sum_am, sum_inf = _presum_from_host(query, plan, kind, dev0)
        else:
            pres = msm.presum_g1 if kind == "g1" else msm.presum_g2_am
            sum_am, sum_inf = pres(am, inf, plan)
        V = int(plan.heavy_scalars.shape[0])
        small = msm.msm_lm if kind == "g1" else msm.msm_lm_g2
        extra = small(sum_am.to(dev0), sum_inf.to(dev0),
                      to_torch(plan.heavy_scalars, dev0),
                      c=4 if V < (1 << 12) else 8, nbits=nbits, chunk=chunk)
        del sum_am, sum_inf
        scalars_std = scalars_std.clone()
        scalars_std[torch.from_numpy(plan.hpos).to(scalars_std.device)] = 0

    n = N // D
    t0 = time.perf_counter()
    parts = [_shard_query(query, i * n, (i + 1) * n, dev)
             for i, dev in enumerate(mesh)]
    if record is not None and host:
        synchronize(mesh)
        record["upload_s"] = time.perf_counter() - t0
    wins = []
    for i, dev in enumerate(mesh):
        P_i, inf_i = single._consume(parts[i])
        parts[i] = None  # a narrow part goes once it is widened
        wins.append(msm._msm_v3(P_i, inf_i,
                                scalars_std[i * n:(i + 1) * n].to(dev),
                                c, nbits, chunk, kind))
        del P_i, inf_i
    main = msm._combine(kind, _reduce_parts(wins, kind, dev0), c)
    return add(main, extra)


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
    """`groth16.prove.create_proof` over the mesh: the same math and wire
    bytes, with the five MSMs on `msm_sharded_v3` and the h phase on
    `compute_h_sharded`.  Witness encode, row evaluation and the dedup
    plans run as in `create_proof`, on shard 0's device; the key's queries
    may lie on a card or on the host.  Np must divide by the mesh's size.
    If `record` is a dict it gets per-stage seconds (the cards
    synchronised at each stage boundary; `upload_*` a host query's
    uploads, outside its `msm_*`) and the dedup plan's heavy-value count."""
    dev = mesh[0]
    t_last = [time.perf_counter()]
    stages = {}

    def tick(name, less: float = 0.0):
        if record is None:
            return
        synchronize(mesh)
        now = time.perf_counter()
        stages[name] = now - t_last[0] - less
        t_last[0] = now

    pk = params.pk
    Np = pk.a_query[0].shape[0]
    if Np % len(mesh):
        raise ValueError(f"the mesh ({len(mesh)} shards) must divide the "
                         f"key's length Np = {Np}")
    dr = params.dev_r1cs
    if (dr is None or dr.c.n_constraints != cs.n_constraints
            or dr.device != dev):
        dr = DeviceR1CS(cs.compiled(), dev)
        params.dev_r1cs = dr
    n_inputs = dr.c.num_inputs
    num_vars = dr.c.num_vars
    if r is None:
        r = secrets.randbelow(bls.R)
    if s is None:
        s = secrets.randbelow(bls.R)
    F = fr_field()
    tick("setup")

    z_ints = cs.full_assignment()
    if len(z_ints) != num_vars:
        raise SynthesisError("assignment/circuit shape mismatch")
    d = qap.domain_size(dr.c.n_constraints, n_inputs)
    z_np = np.zeros((Np, 16), np.uint32)
    z_np[:num_vars] = ints_to_array([v % P for v in z_ints], 16)
    del z_ints
    z_std = to_torch(z_np, dev)
    z_mont = F.to_mont(z_std)
    tick("witness_encode")

    with ThreadPoolExecutor(max_workers=1) as pool:
        plans = pool.submit(single._dedup_plans, z_np, n_inputs)
        evs = [single._pad_rows(p.eval(z_mont, dr.pal_mont), d)
               for p in dr.row_plans]
        del z_mont
        tick("row_eval")
        h_std = compute_h_sharded(mesh, evs, d)
        tick("h_ntt")
        plan_z, plan_aux = plans.result()
    aux = torch.zeros_like(z_std)
    aux[: num_vars - n_inputs] = z_std[n_inputs:num_vars]
    tick("dedup_plans")

    jobs = [("a", pk.a_query, z_std, plan_z, "g1"),
            ("b_g1", pk.b_g1_query, z_std, plan_z, "g1")]
    if d > 1:
        jobs.append(("h", pk.h_query, single._pad_rows(h_std, Np), None,
                     "g1"))
    if num_vars > n_inputs:
        jobs.append(("l", pk.l_query, aux, plan_aux, "g1"))
    jobs.append(("b_g2", pk.b_g2_query, z_std, plan_z, "g2"))
    del h_std, aux, z_std
    c_full = single._msm_c(Np)
    sums = {"h": None, "l": None}
    while jobs:
        name, query, scalars, plan, kind = jobs.pop(0)
        up = {}
        sums[name] = msm_sharded_v3(
            mesh, query, scalars, kind, c=c_full, dedup_plan=plan,
            record=None if record is None else up)
        del scalars
        if "upload_s" in up:
            stages[f"upload_{name}"] = up["upload_s"]
        tick(f"msm_{name}", up.get("upload_s", 0.0))

    proof = single.assemble(pk, sums, r, s)
    tick("combine")
    if record is not None:
        record["seconds"] = stages
        record["n_heavy_vals"] = plan_z.n_heavy_vals
        record["shards"] = [str(x) for x in mesh]
    return proof
