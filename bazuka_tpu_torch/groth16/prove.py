"""Groth16 prover on the card (port of `bazuka_tpu/groth16/prove.py`).

  1. witness limb encode on the host in one native pass
     (groth16.witness), one narrow upload, one to_mont multiply
  2. a_j, b_j, c_j per extended constraint row: sparse row evaluation
     (groth16.sparse)
  3. h(x) = (a(x)·b(x) − c(x)) / Z(x) via 3 iNTT + 3 coset NTT + 1 coset
     iNTT; on the coset gH, Z is the constant g^d − 1
  4. A = α + Σ z_i u_i(τ) + rδ;  B = β + Σ z_i v_i(τ) + sδ;
     C = (Σ_aux z_i L_i + Σ h_i H_i) + sA + rB₁ − rsδ
     — four G1 MSMs and one G2 MSM (ops.msm_lm), the witness ones with
     the duplicate-scalar presum
  5. the host combine into (A, B, C)

The dedup plans (host numpy over the witness) are built on a worker thread
while the card runs stages 2-3, as the JAX version does; an error there
reaches the caller when the MSMs need the plans.

Big mode, from d = BIG_DOMAIN (the JAX package's, `bazuka_tpu/groth16/
prove.py:36-40, 95-176, 195-236, 291-502`): the witness stays narrow on
the card (int16 limbs) through the h phase and is widened after it; the h
phase parks its idle polynomials narrow; the G2 MSM presums over the narrow
query and drains in two halves, widening one at a time (`_g2_msm_big`), on
chunks of 2^17 points.  In every mode a query that lives on the host (a
key under `device_queries` "g1" or False) is uploaded narrow just before
its MSM and widened on the card (no prefetch: the JAX package's
PREFETCH_MAX_BYTES overlap is not ported), and the scalars of each MSM
are handed over in one-element lists that the MSM empties
(`msm_lm.take_scalars`), so that a dedup drain's zeroed copy does not sit
beside the tensor it was copied from once no later MSM needs that.

The JAX package waits for each big-mode stage to finish (`_sync`) because
its asynchronous dispatch let consecutive stages' transients coexist in
device memory.  PyTorch's caching allocator reuses a freed block in the
order of its one stream, so a tensor freed on the host is reused by the
next stage without a wait; the port's stages run without one.
"""

from __future__ import annotations

import contextvars
import secrets
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ..crypto import bls12_381 as bls
from ..device import resolve_device
from ..fields.host import FR_GENERATOR, FR_MODULUS
from ..fields.limbs import (fr_field, narrow_limbs, narrow_to_device,
                            widen_flags, widen_limbs)
from ..ops import msm_lm as msm
from ..ops import ntt as ntt_mod
from ..utils import spans
from ..zk.proof import Groth16Proof
from . import qap
from .keygen import Parameters, g1_wire, g2_wire
from .r1cs import ConstraintSystem
from .sparse import DeviceR1CS
from .witness import encode_assignment

P = FR_MODULUS

# From this domain size the prover runs in big mode.  A module constant,
# so that tests and small runs can lower it.
BIG_DOMAIN = 1 << 23


def _msm_c(n: int) -> int:
    """Window size by MSM length: balances drain rounds (~n/2^c) against
    lane count (n_windows * 2^c)."""
    if n >= 1 << 18:
        return 12
    if n >= 1 << 12:
        return 8
    return 4


# ------------------------------------------------------ the narrow wire
#
# Every limb is a 16-bit payload, so a host query goes to the card as
# uint16 limbs and uint8 flags (`fields.limbs.narrow_to_device`, the JAX
# package's `_narrow_np` and `_device_put_narrow`; int16/uint8 there) and
# is widened on the card to the kernels' int32 limbs and bool flags.


def _widen_u32(x: torch.Tensor) -> torch.Tensor:
    """Narrow limbs or flags on the card -> the kernels' int32 limbs or
    bool flags (a new tensor); wide ones pass through."""
    if x.dim() == 1:
        return widen_flags(x)
    return widen_limbs(x)


def compute_h_mont(evs: list, d: int):
    """[ea, eb, ec] (d, 16) Montgomery row evaluations -> h(x)
    coefficients (length d-1) as standard-form limbs.  Pops each input
    as it is transformed so its memory is freed early; from d =
    BIG_DOMAIN the polynomials that wait are parked narrow (int16) and
    widened when their turn comes."""
    F = fr_field()
    dev = evs[0].device
    big = d >= BIG_DOMAIN

    def park(x):
        return narrow_limbs(x) if big else x

    def coset(x):
        return ntt_mod.coset_ntt_mont(ntt_mod.ntt_mont(x, True))

    assert len(evs) == 3
    evs[1] = park(evs[1])
    evs[2] = park(evs[2])
    ca = park(coset(evs.pop(0)))
    cb = coset(widen_limbs(evs.pop(0)))
    ab = park(F.mont_mul(widen_limbs(ca), cb))
    del ca, cb
    cc = coset(widen_limbs(evs.pop(0)))
    z_on_coset = (pow(FR_GENERATOR, d, P) - 1) % P
    zinv = F.const_mont(pow(z_on_coset, -1, P), dev)
    h_evals = F.mont_mul(F.sub(widen_limbs(ab), cc), zinv[None])
    del ab, cc
    h_coeffs = ntt_mod.coset_intt_mont(h_evals)
    del h_evals
    # degree <= d-2: drop the top coefficient, standard form for the MSM
    return F.from_mont(h_coeffs[: d - 1])


def _pad_rows(x, d: int):
    n = x.shape[0]
    if n == d:
        return x
    return torch.cat([x, x.new_zeros((d - n, x.shape[1]))])


def _dedup_plans(z_np: np.ndarray, n_inputs: int):
    with spans.span("dedup.build"):
        plan_z = msm.make_dedup_plan(z_np)
        return plan_z, plan_z.derive_shifted(n_inputs)


def _opening(name: str, query) -> str:
    """The first stage of MSM `name`: its query's upload if the query
    lives on the host, else the MSM."""
    return f"upload_{name}" if isinstance(query[0], np.ndarray) \
        else f"msm_{name}"


def _g2_msm_big(query, scalars_std, plan, c: int, chunk: int):
    """Big-mode G2 MSM over the narrow query ((N, 4, 24) int16 limbs,
    (N,) uint8 flags on the card; wide ones work too): the whole widened
    query never exists.  The heavy groups' presum reads the narrow query
    (each round widens the rows it gathers), then the drain runs as two
    half-length MSMs, each over one widened half, combined by a host G2
    add (`bazuka_tpu/groth16/prove.py:195-236`).  The scalars may be
    handed over in a list, as to `msm_lm`."""
    am_n, inf_n = query
    inf = _widen_u32(inf_n)
    total, scalars_std = msm.dedup_split(
        "g2", plan, lambda: msm.presum_g2_am(am_n, inf, plan), scalars_std,
        chunk=chunk)
    half = int(am_n.shape[0]) // 2
    for lo in (0, half):
        wide = _widen_u32(am_n[lo:lo + half])
        part = msm.msm_lm_g2(wide, inf[lo:lo + half],
                             scalars_std[lo:lo + half], c=c, chunk=chunk)
        del wide
        total = bls.g2_add(total, part)
    return total


def _put(query, device):
    """A query on the card: as it is if it lives there, else uploaded
    narrow."""
    am, inf = query
    if not isinstance(am, np.ndarray):
        return query
    return (narrow_to_device(am, device), narrow_to_device(inf, device))


def _consume(q):
    """A query on the card -> the kernels' wide form (widened copies of a
    narrow query; a wide one as it is)."""
    return tuple(_widen_u32(t) for t in q)


def assemble(pk, sums: dict, r: int, s: int) -> Groth16Proof:
    """The host combine of the five MSMs' sums ("a", "b_g1", "h", "l",
    "b_g2"; None for the zero sum) with α, β, δ and r, s into (A, B, C)."""
    g1a = bls.g1_add
    A_pt = g1a(g1a(pk.alpha_g1, sums["a"]), bls.g1_mul(pk.delta_g1, r))
    B1_pt = g1a(g1a(pk.beta_g1, sums["b_g1"]), bls.g1_mul(pk.delta_g1, s))
    B2_pt = bls.g2_add(
        bls.g2_add(pk.beta_g2, sums["b_g2"]), bls.g2_mul(pk.delta_g2, s)
    )
    C_pt = g1a(
        g1a(
            g1a(sums["l"], sums["h"]),
            g1a(bls.g1_mul(A_pt, s), bls.g1_mul(B1_pt, r)),
        ),
        bls.g1_neg(bls.g1_mul(pk.delta_g1, r * s % bls.R)),
    )
    return Groth16Proof(a=g1_wire(A_pt), b=g2_wire(B2_pt), c=g1_wire(C_pt))


def prove_with(params: Parameters, cs: ConstraintSystem, dev,
               r: Optional[int], s: Optional[int], record: Optional[dict],
               sync, compute_h, put, run_msm,
               big_from: Optional[int] = None) -> Groth16Proof:
    """The stages of one proof, shared by `create_proof` and
    `parallel.prove.create_proof_sharded`, which hand in what differs:
    `compute_h(evs, d)` (h's standard-form coefficients on `dev`),
    `put(query)` (a key's query where `run_msm` reads it) and
    `run_msm(kind, q, box, plan, c, big)` (one MSM's host sum, "g1" or
    "g2", its scalars in the one-element list `box`).  From d = big_from
    (None: never) the proof runs in big mode.  `sync` synchronises the
    device(s) at each stage boundary if `record` is a dict
    (`create_proof`'s record)."""
    st = spans.Stages("setup", sync if record is not None else None)
    pk = params.pk
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
    st.next("witness_encode")

    Np = pk.a_query[0].shape[0]
    d = qap.domain_size(dr.c.n_constraints, n_inputs)
    big = big_from is not None and d >= big_from
    z_np = encode_assignment(cs, num_vars, Np)
    z_narrow = narrow_to_device(z_np, dev)
    if big:  # only the narrow z is held through the h phase
        z_mont = F.to_mont(_widen_u32(z_narrow))
    else:
        z_std = _widen_u32(z_narrow)
        del z_narrow
        z_mont = F.to_mont(z_std)
    st.next("row_eval")

    with ThreadPoolExecutor(max_workers=1) as pool:
        # the worker's spans land in this call
        plans = pool.submit(contextvars.copy_context().run, _dedup_plans,
                            z_np, n_inputs)
        evs = [_pad_rows(p.eval(z_mont, dr.pal_mont), d)
               for p in dr.row_plans]
        del z_mont
        st.next("h_ntt")
        h_std = compute_h(evs, d)
        st.next("dedup_plans")
        # the wait for the plans past the h phase
        plan_z, plan_aux = plans.result()
    if big:
        z_std = _widen_u32(z_narrow)
        del z_narrow
    # aux = z shifted down by the public inputs, a zero tail: on the card
    aux = torch.zeros_like(z_std)
    aux[: num_vars - n_inputs] = z_std[n_inputs:num_vars]
    st.next(_opening("a", pk.a_query))

    # every query has the same padded length Np (scalars zero-padded); the
    # scalars ride in one-element lists that each MSM empties, so that the
    # last MSM of a tensor holds its only reference
    jobs = [("a", pk.a_query, "g1", [z_std], plan_z),
            ("b_g1", pk.b_g1_query, "g1", [z_std], plan_z)]
    if d > 1:
        jobs.append(("h", pk.h_query, "g1", [_pad_rows(h_std, Np)], None))
    if record is not None and not big:
        record["h_std"] = h_std
    del h_std
    if num_vars > n_inputs:
        jobs.append(("l", pk.l_query, "g1", [aux], plan_aux))
    del aux
    jobs.append(("b_g2", pk.b_g2_query, "g2", [z_std], plan_z))
    del z_std
    c = _msm_c(Np)
    sums = {"h": None, "l": None}
    for k, (name, query, kind, box, plan) in enumerate(jobs):
        q = put(query)
        if isinstance(query[0], np.ndarray):
            st.next(f"msm_{name}")
        sums[name] = run_msm(kind, q, box, plan, c, big)
        del q
        st.next(_opening(*jobs[k + 1][:2]) if k + 1 < len(jobs)
                else "combine")

    proof = assemble(pk, sums, r, s)
    st.end()
    if record is not None:
        record["seconds"] = st.seconds
        record["n_heavy_vals"] = plan_z.n_heavy_vals
        record["big_mode"] = big
    return proof


def _run_msm(kind: str, q, box, plan, c: int, big: bool):
    """One MSM of the proof on one device; in big mode the G2 query
    passes through narrow, widened per half."""
    if kind == "g1":
        return msm.msm_lm(*_consume(q), box, c=c, dedup_plan=plan)
    if big:
        return _g2_msm_big(q, box, plan, c, 1 << 17)
    return msm.msm_lm_g2(*_consume(q), box, c=c, chunk=1 << 18,
                         dedup_plan=plan)


@spans.call("create_proof")
def create_proof(
    params: Parameters,
    cs: ConstraintSystem,
    r: Optional[int] = None,
    s: Optional[int] = None,
    device="cuda",
    record: Optional[dict] = None,
) -> Groth16Proof:
    """One Groth16 proof.  `cs` is anything with `n_constraints`,
    `compiled()` and `full_assignment()`.  If `record` is a dict it is
    filled with per-stage seconds (the card synchronised at each stage
    boundary; `upload_*` the wait for a host query's upload), the dedup
    plan's heavy-value count, whether big mode ran and, below BIG_DOMAIN,
    the h coefficients ("h_std"; big mode keeps one copy of h, the MSM's
    padded one).  The stages are spans of the call either way
    (`utils.spans`); only `record` synchronises."""
    dev = resolve_device(device)
    return prove_with(
        params, cs, dev, r, s, record,
        (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
        else None,
        compute_h_mont, lambda query: _put(query, dev), _run_msm,
        big_from=BIG_DOMAIN)
