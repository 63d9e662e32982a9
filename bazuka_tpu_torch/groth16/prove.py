"""Groth16 prover on the card (port of `bazuka_tpu/groth16/prove.py`).

  1. witness limb encode on the host, one upload, one to_mont multiply
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

The JAX version's "big mode" (d >= 2^23: serialized stages, half-width
parked tensors, narrow-wire uploads) is not ported: at d = 2^22 an 80 GB
card holds every stage at full width.
"""

from __future__ import annotations

import secrets
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ..crypto import bls12_381 as bls
from ..device import resolve_device
from ..fields.host import FR_GENERATOR, FR_MODULUS
from ..fields.limbs import fr_field, ints_to_array, to_torch
from ..ops import msm_lm as msm
from ..ops import ntt as ntt_mod
from ..zk.proof import Groth16Proof
from . import qap
from .keygen import Parameters, g1_wire, g2_wire
from .r1cs import ConstraintSystem, SynthesisError
from .sparse import DeviceR1CS

P = FR_MODULUS


def _msm_c(n: int) -> int:
    """Window size by MSM length: balances drain rounds (~n/2^c) against
    lane count (n_windows * 2^c)."""
    if n >= 1 << 18:
        return 12
    if n >= 1 << 12:
        return 8
    return 4


def compute_h_mont(evs: list, d: int):
    """[ea, eb, ec] (d, 16) Montgomery row evaluations -> h(x)
    coefficients (length d-1) as standard-form limbs.  Pops each input
    as it is transformed so its memory is freed early."""
    F = fr_field()
    dev = evs[0].device

    def coset(x):
        return ntt_mod.coset_ntt_mont(ntt_mod.ntt_mont(x, True))

    assert len(evs) == 3
    ca = coset(evs.pop(0))
    cb = coset(evs.pop(0))
    ab = F.mont_mul(ca, cb)
    del ca, cb
    cc = coset(evs.pop(0))
    z_on_coset = (pow(FR_GENERATOR, d, P) - 1) % P
    zinv = F.const_mont(pow(z_on_coset, -1, P), dev)
    h_evals = F.mont_mul(F.sub(ab, cc), zinv[None])
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
    plan_z = msm.make_dedup_plan(z_np)
    return plan_z, plan_z.derive_shifted(n_inputs)


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
    boundary), the dedup plan's heavy-value count and the h coefficients."""
    dev = resolve_device(device)
    sync = record is not None and dev.type == "cuda"
    t_last = [time.perf_counter()]
    stages = {}

    def tick(name):
        if record is None:
            return
        if sync:
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        stages[name] = now - t_last[0]
        t_last[0] = now

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
    tick("setup")

    z_ints = cs.full_assignment()
    if len(z_ints) != num_vars:
        raise SynthesisError("assignment/circuit shape mismatch")
    Np = pk.a_query[0].shape[0]
    d = qap.domain_size(dr.c.n_constraints, n_inputs)
    z_np = np.zeros((Np, 16), np.uint32)
    z_np[:num_vars] = ints_to_array([v % P for v in z_ints], 16)
    z_std = to_torch(z_np, dev)
    z_mont = F.to_mont(z_std)
    tick("witness_encode")

    with ThreadPoolExecutor(max_workers=1) as pool:
        plans = pool.submit(_dedup_plans, z_np, n_inputs)
        evs = [_pad_rows(p.eval(z_mont, dr.pal_mont), d)
               for p in dr.row_plans]
        del z_mont
        tick("row_eval")
        h_std = compute_h_mont(evs, d)
        tick("h_ntt")
        # the wait for the plans past the h phase
        plan_z, plan_aux = plans.result()
    aux = torch.zeros_like(z_std)
    aux[: num_vars - n_inputs] = z_std[n_inputs:num_vars]
    tick("dedup_plans")

    # every query has the same padded length Np (scalars zero-padded)
    c_full = _msm_c(Np)
    jobs = [("a", pk.a_query, z_std, plan_z, msm.msm_lm),
            ("b_g1", pk.b_g1_query, z_std, plan_z, msm.msm_lm)]
    if d > 1:
        jobs.append(("h", pk.h_query, _pad_rows(h_std, Np), None, msm.msm_lm))
    if num_vars > n_inputs:
        jobs.append(("l", pk.l_query, aux, plan_aux, msm.msm_lm))
    jobs.append(("b_g2", pk.b_g2_query, z_std, plan_z, msm.msm_lm_g2))
    sums = {"h": None, "l": None}
    for name, query, scalars, plan, run in jobs:
        sums[name] = run(query[0], query[1], scalars, c=c_full,
                         dedup_plan=plan)
        tick(f"msm_{name}")

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
    proof = Groth16Proof(a=g1_wire(A_pt), b=g2_wire(B2_pt), c=g1_wire(C_pt))
    tick("combine")
    if record is not None:
        record["seconds"] = stages
        record["n_heavy_vals"] = plan_z.n_heavy_vals
        record["h_std"] = h_std
    return proof
