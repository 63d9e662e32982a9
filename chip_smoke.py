#!/usr/bin/env python3
"""Run the PyTorch + CUDA port (`bazuka_tpu_torch`) on one NVIDIA GPU and
check it.

    python3 chip_smoke.py              # d = Np = 2^22 (the default)
    python3 chip_smoke.py --log-d 20   # smaller real-size proof and key

Phases, each printed as one JSON line:
  1. device   card name and power limit (nvidia-smi), torch and CUDA versions
  2. build    nvcc builds every kernel from `bazuka_tpu_torch/csrc/`
  3. toy      the committed toy key (tests/data/toy_multiply_params.npz),
              2-constraint multiply circuit at r = 7, s = 11: the proof's
              wire bytes equal the JAX package's (pinned below), and
              groth16_verify accepts [z] and rejects [z+1] and [z, 0]
  4. proof    one `create_proof` at d = Np = 2^22 on a synthetic circuit of
              the MPN batch-64 update proof's size (3,275,554 constraints)
              and a key whose every point has a known discrete log: A, B, C
              equal the points computed on the host from scalars alone, and
              h(x) satisfies a(ρ)·b(ρ) − c(ρ) = h(ρ)·Z(ρ) at a random ρ, with
              a(ρ), b(ρ), c(ρ) summed over the circuit's own terms
              (barycentric Lagrange basis; neither the port's row plans nor
              its NTT).  The kernels' launch counts and sizes are recorded;
              K1's four entries (the Fr and Fp multiplies, the NTT's
              stages, the Fp inversion) and K2-K5 must each have run.
              Then `msm_a` and `msm_b_g2` once
              more, timed alone and under torch.profiler (`drain_profile`
              lines: device time by kernel, device idle share), and the h
              phase the same way, without the dedup-plan thread and after
              a run that rebuilds its NTT tables (`h_profile`)
  5. keygen   `generate_parameters` on the card: the key of the same
              synthetic MPN-b64-sized circuit at d = Np = 2^22, from a cold
              start (its launch counts and sizes are recorded; K6, K7, K1's
              multiplies and its Fp inversion must each have run), with 16
              rows of each query (first and
              last valid row, a pad row) and every VK point equal to the
              generator times a scalar recomputed on the host from the
              circuit's own terms, and a proof under that key that
              groth16_verify accepts for [x] and rejects for [x + 1]; then
              the toy multiply circuit at seed b"test", which must equal the
              committed key (all ten query arrays, the head points, the VK's
              wire bytes).  Then one `_gen_mul_am` chunk of 65,536 scalars
              on G1 and one on G2 under torch.profiler (`gen_mul_profile`
              lines: device time by kernel, the rest by PyTorch kernel
              name, idle share)
  6. kernel   each kernel replayed at every size phases 4 and 5 launched it
              with, on fresh random operands (plus the edge cases: 0 and
              p − 1 among K1's operands and the NTT's inputs, R − 1 in one
              of K1's operands against a canonical other, 0, 1 and
              p − 1 among the inversion's; for the curve adds K2-K7 also
              active lanes of p − 1 and 0 in every coordinate, Z2
              included; K6/K7 always also at 65,535 and 65,536 lanes),
              against its plain PyTorch
              version: bit-identical limbs, its time, the plain version's
              time and the card's bound, per size and averaged over the
              phases' launches
Then the `{"kernels": [...]}` line (launch counts of the phases that ran
each kernel, times averaged over their launches) and the last line
`{"ok": true, "device": {...}}`.  Any failed check raises, so the script
exits non-zero and prints no result.  Without a CUDA device it exits with
code 2.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from bazuka_tpu_torch.crypto import bls12_381 as bls
from bazuka_tpu_torch.fields.host import FR_GENERATOR, FR_MODULUS
from bazuka_tpu_torch.fields.limbs import (
    FP_LIMBS,
    FR_LIMBS,
    fp_field,
    fr_field,
    int_to_limbs,
    ints_to_array,
    to_torch,
)
from bazuka_tpu_torch.groth16 import keygen, prove, qap
from bazuka_tpu_torch.groth16.r1cs import (
    ONE,
    CompiledR1CS,
    ConstraintSystem,
    lc,
)
from bazuka_tpu_torch.groth16.verify import groth16_verify
from bazuka_tpu_torch.ops import _cuda
from bazuka_tpu_torch.ops import curve_kernels as ck
from bazuka_tpu_torch.ops import field_kernel as fk
from bazuka_tpu_torch.ops import msm_lm
from bazuka_tpu_torch.ops import ntt as ntt_mod
from bazuka_tpu_torch.ops import weierstrass as wst
from bazuka_tpu_torch.utils import ser
from bazuka_tpu_torch.zk.proof import Groth16VerifyingKey

P = FR_MODULUS
R_ORDER = bls.R
ROOT = os.path.dirname(os.path.abspath(__file__))
TOY_KEY = os.path.join(ROOT, "tests", "data", "toy_multiply_params.npz")

# Wire bytes of bazuka_tpu's proof of the toy multiply circuit (x = 3,
# y = 5) under the committed key at r = 7, s = 11;
# tests/test_torch_prove.py holds this constant against a live JAX proof.
TOY_PROOF_HEX = (
    "080f5cda6540f4a3dc5d5a6af40012bc5026ef149437f06b5085bdacfe2e3677"
    "7f14e4ff22fc5b58a57134faab11d118a83b7b2036d0984a30daf9f33760278a"
    "5f52f37de71e453f102f1b316c2e641bcd78079feaa4fc2e99f2647743c72609"
    "00de611bbf1c2251707b8371d8df9b6361fa40f382e33ec6ffb24610e2651fd8"
    "0dbad5ae401a305f1e04036ef710a5e419de0629e240e6cb1ce3879795700879"
    "a0d2435e5768c256d64ffa8c3463753ae9022290c4096db1e21b2d94dc4388e7"
    "149c267f1c27cb22cd5504368dce773a2625d64804d517a346f6d03c6e49a6fc"
    "053d3bba4caa94a6f96d048913800f440ecd6c77686a6c00795b3aabde51fa06"
    "e561cc1a17e38da28f2aadcd55870b246b10ade337afbe943cbe74d1c82a8a26"
    "0700ae22c54cbccfc8e5c90333d88af961435061cdc8741b53c55b7194626ce3"
    "6f782193e00cefceaea0606ff3db313fbe0dbb0aa911388417da003af63cee9f"
    "d8e93d3e7a4396bbc8e6c09a4ce36a3a008d3e8a2a81d08436651ae8fa2dbea5"
    "361800"
)

# seeds the synthetic circuit, its key and the evaluation point ρ
ROOT_SEED = 22

# MPN update proof at batch 64: 3,275,554 constraints, d = 2^22.
MPN_B64_CONSTRAINTS = 3_275_554

# H100 SXM peaks: HBM3 bytes/s (NVIDIA data sheet), and 32-bit integer
# multiply-adds/s = 132 SMs x 64 IMAD per SM per clock (CUDA C++
# Programming Guide, arithmetic throughput, compute capability 9.0) x the
# 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 132 * 64 * 1.98e9


def mont_mul_imads(n_limbs: int) -> int:
    """32-bit multiply-adds of one CIOS Montgomery multiply over s = n/2
    words: s^2 word products and s^2 + s reduction products, each word
    product a low and a high IMAD, the m = t0 * p' products one IMAD."""
    s = n_limbs // 2
    return 2 * s * s + 2 * s * s + s


def mont_sqr_imads(n_limbs: int) -> int:
    """The same for a Montgomery squaring: s(s + 1) / 2 distinct word
    products (the doubled cross products are shifts and adds), then the
    reduction."""
    s = n_limbs // 2
    return s * (s + 1) + 2 * s * s + s


def ntt_imads(n: int) -> int:
    """32-bit multiply-adds of the radix-2 stages of an n-point NTT over
    Fr: one multiply per butterfly, less those whose twiddle is 1 (the
    first of each group, n - 1 in all)."""
    return (n // 2 * (n.bit_length() - 1) - (n - 1)) * mont_mul_imads(16)


def bound(nbytes: int, imads: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = imads / IMAD_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def emit(obj):
    print(json.dumps(obj), flush=True)


# ------------------------------------------------------------ synthetic data


class SyntheticCircuit:
    """A satisfied R1CS shaped like the MPN witness, built with numpy.

    Var 0 is ONE, var 1 the public input x = c_0.  Half the constraints are
    boolean wires (1 − b)·b = 0 (a dense ONE column, coefficient −1, and one
    huge group of equal scalars for the duplicate-scalar presum); the rest
    are a multiply chain c_k = c_{k−1}·c_{j(k)} with random earlier factors.
    Exposes what `create_proof` reads: `n_constraints`, `compiled()` and
    `full_assignment()`."""

    def __init__(self, n_constraints: int, seed: int):
        rng = np.random.default_rng(seed)
        nb = n_constraints // 2
        k = n_constraints - nb
        self.n_constraints = n_constraints
        bits = rng.integers(0, 2, nb)
        # factor of chain step t (1..k): an earlier chain value j in [0, t)
        j = (rng.random(k) * np.arange(1, k + 1)).astype(np.int64)
        x = int.from_bytes(rng.bytes(32), "little") % P
        chain = [x]
        for t in range(k):
            chain.append(chain[t] * chain[j[t]] % P)
        self.z = [1, x] + bits.tolist() + chain[1:]

        def cvar(t):  # var index of chain value c_t
            return np.where(t == 0, 1, 2 + nb + t - 1)

        rb = np.arange(nb, dtype=np.int64)
        bvar = 2 + rb
        t = np.arange(1, k + 1, dtype=np.int64)
        rc = nb + t - 1
        one = np.zeros(nb, np.int64)
        rows = (np.concatenate([np.repeat(rb, 2), rc]),
                np.concatenate([rb, rc]), rc)
        vars_ = (np.concatenate([np.stack([one, bvar], 1).ravel(),
                                 cvar(t - 1)]),
                 np.concatenate([bvar, cvar(j)]), cvar(t))
        cids = (np.concatenate([np.tile([0, 1], nb), np.zeros(k, np.int64)]),
                np.zeros(nb + k, np.int64), np.zeros(k, np.int64))
        self._compiled = CompiledR1CS(
            num_vars=len(self.z), num_inputs=2, n_constraints=n_constraints,
            rows=tuple(a.astype(np.int32) for a in rows),
            vars=tuple(a.astype(np.int32) for a in vars_),
            cids=tuple(a.astype(np.int32) for a in cids),
            palette=[1, P - 1],
        )

    def compiled(self) -> CompiledR1CS:
        return self._compiled

    def full_assignment(self):
        return self.z


def _gen(kind):
    return bls.G1_GEN if kind == "g1" else bls.G2_GEN


def _coords(kind, pt, proj: bool):
    """Host point -> Montgomery coordinate ints in the limb-major plane
    order (x y [z] for G1, x0 x1 y0 y1 [z0 z1] for G2)."""
    if kind == "g1":
        c = [0, 1, 0] if pt is None else [pt[0], pt[1], 1]
        return c if proj else c[:2]
    c = ([0, 0, 1, 0, 0, 0] if pt is None
         else [pt[0][0], pt[0][1], pt[1][0], pt[1][1], 1, 0])
    return c if proj else c[:4]


def broadcast_lanes(kind, pt, n: int, proj: bool, device):
    """One host point in every one of n limb-major lanes."""
    col = fp_field().encode(np.array(_coords(kind, pt, proj), dtype=object),
                            device=device)  # (planes, 24)
    return col[:, :, None].expand(-1, -1, n).contiguous()


def prefix_points(kind: str, a: int, b: int, n: int, device):
    """Limb-major projective points (a + i·b)·G for i < n, built on the
    device with log2(n) masked mixed adds (K2 or K4): lane i adds 2^k·b·G
    where bit k of i is set."""
    add = bls.g1_add if kind == "g1" else bls.g2_add
    mul = bls.g1_mul if kind == "g1" else bls.g2_mul
    madd = ck.madd_select_lm if kind == "g1" else ck.madd_select_g2_lm
    acc = broadcast_lanes(kind, mul(_gen(kind), a % R_ORDER), n, True, device)
    step = mul(_gen(kind), b % R_ORDER)
    lane = torch.arange(n, device=device)
    k = 0
    while (1 << k) < n:
        q = broadcast_lanes(kind, step, n, False, device)
        acc = madd(acc, q, ((lane >> k) & 1).bool())
        step = add(step, step)
        k += 1
    return acc


def lm_to_am(kind: str, acc):
    """Limb-major projective (n_proj, 24, L) -> ((L, n_aff, 24), (L,) inf)."""
    if kind == "g1":
        return wst.g1_proj_to_am((acc[0].T, acc[1].T, acc[2].T))
    return wst.g2_proj_to_am(((acc[0].T, acc[1].T), (acc[2].T, acc[3].T),
                              (acc[4].T, acc[5].T)))


def synthetic_params(num_vars: int, n_inputs: int, d: int, seed: int,
                     device):
    """A proving key whose query point i is (a_q + i·b_q)·G for random a_q,
    b_q, and whose α, β, δ are known: returns (Parameters, scalars).  Rows
    past each query's length are infinity, as keygen pads them.  b_g1 and
    b_g2 share their logs, as v_i(τ) is shared in a real key."""
    rng = np.random.default_rng(seed)

    def rand():
        return int.from_bytes(rng.bytes(40), "little") % (R_ORDER - 1) + 1

    sc = {name: rand() for name in ("alpha", "beta", "delta")}
    for q in ("a", "b", "l", "h"):
        sc[q] = (rand(), rand())
    Np = msm_lm.msm_pad_len(max(num_vars, d - 1))
    rows = torch.arange(Np, device=device)

    def query(kind, ab, n_valid):
        am, inf = lm_to_am(kind, prefix_points(kind, *ab, Np, device))
        return am, inf | (rows >= n_valid)

    g1, g2 = bls.G1_GEN, bls.G2_GEN
    pk = keygen.ProvingKey(
        alpha_g1=bls.g1_mul(g1, sc["alpha"]),
        beta_g1=bls.g1_mul(g1, sc["beta"]),
        beta_g2=bls.g2_mul(g2, sc["beta"]),
        delta_g1=bls.g1_mul(g1, sc["delta"]),
        delta_g2=bls.g2_mul(g2, sc["delta"]),
        a_query=query("g1", sc["a"], num_vars),
        b_g1_query=query("g1", sc["b"], num_vars),
        b_g2_query=query("g2", sc["b"], num_vars),
        h_query=query("g1", sc["h"], d - 1),
        l_query=query("g1", sc["l"], num_vars - n_inputs),
        num_inputs=n_inputs,
    )
    w1, w2 = keygen.g1_wire, keygen.g2_wire
    # not a verifying key for this circuit: the queries are not the QAP's
    vk = Groth16VerifyingKey(w1(pk.alpha_g1), w1(pk.beta_g1), w2(pk.beta_g2),
                             w2(g2), w1(pk.delta_g1), w2(pk.delta_g2), [])
    return keygen.Parameters(pk=pk, vk=vk), sc


def expected_proof(z, h, n_inputs: int, sc: dict, r: int, s: int):
    """(A, B, C) of the synthetic key from scalars alone:
    Σ_i v_i·(a + i·b) = a·Σv_i + b·Σ i·v_i."""
    def dot(ab, v):
        a, b = ab
        return (a * sum(v) + b * sum(i * x for i, x in enumerate(v))) % R_ORDER

    a_s = (sc["alpha"] + dot(sc["a"], z) + r * sc["delta"]) % R_ORDER
    b_s = (sc["beta"] + dot(sc["b"], z) + s * sc["delta"]) % R_ORDER
    c_s = (dot(sc["l"], z[n_inputs:]) + dot(sc["h"], h) + s * a_s + r * b_s
           - r * s * sc["delta"]) % R_ORDER
    return (bls.g1_mul(bls.G1_GEN, a_s), bls.g2_mul(bls.G2_GEN, b_s),
            bls.g1_mul(bls.G1_GEN, c_s))


def _powers(x: int, n: int, device):
    """(n, 16) Montgomery x^0..x^(n−1), by doubling the prefix."""
    F = fr_field()
    out = F.const_mont(1, device)[None]
    while out.shape[0] < n:
        step = F.const_mont(pow(x, out.shape[0], P), device)
        out = torch.cat([out, F.mont_mul(out, step)])
    return out[:n]


def _limb_sum(x) -> int:
    """Σ over rows of (N, 16) limbs, as the integer Σ_k (Σ limb_k)·2^16k."""
    sums = x.to(torch.int64).sum(dim=0).cpu().tolist()
    return sum(int(v) << (16 * k) for k, v in enumerate(sums))


def circuit_at(comp: CompiledR1CS, z, d: int, rho: int, device):
    """(a(ρ), b(ρ), c(ρ)) of the QAP straight from the circuit: the sum
    over every term (row j, var i, coefficient k) of k·z_i·L_j(ρ), where
    L_j(ρ) = (ρ^d − 1)/d · ω^j/(ρ − ω^j) is the Lagrange basis on H = <ω>
    (barycentric form).  A also holds bellman's input rows a_{n+i} = z_i.
    Reads comp.rows/vars/cids, not the prover's row plans."""
    F = fr_field()
    omega = pow(FR_GENERATOR, (P - 1) // d, P)
    wpow = _powers(omega, d, device)
    den = F.sub(F.const_mont(rho, device).expand(d, FR_LIMBS), wpow)
    wt = F.mont_mul(wpow, F.inv_mont(den))
    z_mont = F.to_mont(F.encode(np.array(z, dtype=object), mont=False,
                                device=device))
    pal = F.encode(np.array(comp.palette, dtype=object), device=device)
    scale = ((pow(rho, d, P) - 1) * pow(d, -1, P)
             * pow(F.R_mod_p, -1, P) % P)
    n, ni = comp.n_constraints, comp.num_inputs
    out = []
    for m in range(3):
        rows, vars_, cids = (torch.from_numpy(x.astype(np.int64)).to(device)
                             for x in (comp.rows[m], comp.vars[m],
                                       comp.cids[m]))
        acc = _limb_sum(F.mont_mul(F.mont_mul(z_mont[vars_], wt[rows]),
                                   pal[cids]))
        if m == 0:
            acc += _limb_sum(F.mont_mul(z_mont[:ni], wt[n:n + ni]))
        out.append(acc * scale % P)
    return out


def h_identity_holds(comp: CompiledR1CS, z, h_std, d: int, rho: int) -> bool:
    """a(ρ)·b(ρ) − c(ρ) == h(ρ)·Z(ρ), Z(ρ) = ρ^d − 1, h(ρ) = Σ_j h_j·ρ^j."""
    F = fr_field()
    dev = h_std.device
    a, b, c = circuit_at(comp, z, d, rho, dev)
    z_rho = (pow(rho, d, P) - 1) % P
    h = _limb_sum(F.mont_mul(h_std, _powers(rho, h_std.shape[0], dev))) % P
    return (a * b - c - h * z_rho) % P == 0


# ------------------------------------------------------------ keygen checks

QUERY_NAMES = ("a_query", "b_g1_query", "l_query", "h_query", "b_g2_query")
HEAD_FIELDS = ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2",
               "num_inputs")


def key_equals_file(params, path: str) -> dict:
    """A generated key against a key file: each query's limbs and flags,
    the head points and the VK's wire bytes."""
    ref = keygen.load_parameters(path, device=params.pk.a_query[0].device)
    out = {}
    for name in QUERY_NAMES:
        (am, inf), (ram, rinf) = getattr(params.pk, name), getattr(ref.pk, name)
        out[name] = bool(torch.equal(am, ram) and torch.equal(inf, rinf))
    out["head"] = all(getattr(params.pk, f) == getattr(ref.pk, f)
                      for f in HEAD_FIELDS)
    out["vk_bytes"] = ser.dumps(params.vk) == ser.dumps(ref.vk)
    return out


def lagrange_host(rows, tau: int, d: int) -> dict:
    """{j: L_j(τ)} for the given rows from the barycentric form
    ω^j (τ^d − 1) / (d (τ − ω^j)).  ω^j is a running product over the
    sorted rows and the denominators are inverted together (prefix
    products, one inversion): the ONE column touches ~1.6M rows at
    d = 2^22."""
    omega = pow(FR_GENERATOR, (P - 1) // d, P)
    scale = (pow(tau, d, P) - 1) * pow(d, -1, P) % P
    js = np.unique(rows).tolist()
    steps = {}
    ws, wj, prev = [], 1, 0
    for j in js:
        gap = j - prev
        if gap not in steps:
            steps[gap] = pow(omega, gap, P)
        wj = wj * steps[gap] % P
        ws.append(wj)
        prev = j
    prefix = [1]
    for w in ws:
        prefix.append(prefix[-1] * (tau - w) % P)
    inv = pow(prefix[-1], -1, P)
    out = {}
    for i in range(len(js) - 1, -1, -1):
        out[js[i]] = ws[i] * scale % P * (prefix[i] * inv % P) % P
        inv = inv * (tau - ws[i]) % P
    return out


def column_scalars(comp: CompiledR1CS, var_ids, tau: int, d: int) -> dict:
    """{var: [u, v, w]} at τ, each summed over its own column's terms
    (A with bellman's input rows a_{n+i} = z_i)."""
    need = np.array(sorted(set(var_ids)), dtype=np.int64)
    n, ni = comp.n_constraints, comp.num_inputs
    terms = []
    for m in range(3):
        sel = np.isin(comp.vars[m], need)
        terms.append((comp.rows[m][sel], comp.vars[m][sel], comp.cids[m][sel]))
    ext = n + need[need < ni]
    L = lagrange_host(np.concatenate([t[0] for t in terms] + [ext]), tau, d)
    out = {int(v): [0, 0, 0] for v in need}
    for m, (rows, vars_, cids) in enumerate(terms):
        for j, v, c in zip(rows.tolist(), vars_.tolist(), cids.tolist()):
            out[v][m] = (out[v][m] + comp.palette[c] * L[j]) % P
    for v in need[need < ni].tolist():
        out[v][0] = (out[v][0] + L[n + v]) % P
    return out


def sample_rows(n_valid: int, n_rows: int, k: int, rng) -> list:
    """Up to k row indices: the first and last valid row, one pad row if
    there is one, the rest random valid rows."""
    fixed = {0, n_valid - 1}
    if n_rows > n_valid:
        fixed.add(int(rng.integers(n_valid, n_rows)))
    rest = rng.choice(n_valid, size=min(k, n_valid), replace=False).tolist()
    for i in rest:
        if len(fixed) >= k:
            break
        fixed.add(int(i))
    return sorted(fixed)


def gen_mul(kind: str, scalar: int):
    return (bls.g1_mul if kind == "g1" else bls.g2_mul)(_gen(kind), scalar)


def key_points(kind: str, query, idx) -> list:
    """Host affine points of rows idx of a (limbs, inf) query; a row at
    infinity must hold zero limbs (it reads as "bad" otherwise)."""
    am, inf = query
    sel = torch.tensor(idx, device=am.device)
    rows = am[sel]
    decode = keygen._decode_g1_am if kind == "g1" else keygen._decode_g2_am
    zero = (rows == 0).flatten(1).all(dim=1).tolist()
    return [p if p is not None or z else "bad"
            for p, z in zip(decode(rows, inf[sel]), zero)]


def key_spot_check(comp: CompiledR1CS, params, seed: bytes, d: int,
                   k: int = 16, rng_seed: int = ROOT_SEED):
    """Rows of each query and every VK point of a generated key against
    the generator times a scalar recomputed on the host: τ, α, β, γ, δ
    from the seed, u_i(τ), v_i(τ), w_i(τ) from column i's own terms, and
    τ^i·Z(τ)/δ for the h query.  Returns ({check: bool}, rows sampled)."""
    tau, alpha, beta, gamma, delta = keygen._rng_scalars(seed, 5, b"toxic")
    pk, vk = params.pk, params.vk
    ni, nv = comp.num_inputs, comp.num_vars
    n_rows = pk.a_query[0].shape[0]
    valid = {"a_query": nv, "b_g1_query": nv, "b_g2_query": nv,
             "l_query": nv - ni, "h_query": d - 1}
    rng = np.random.default_rng(rng_seed)
    idx = {name: sample_rows(valid[name], n_rows, k, rng)
           for name in QUERY_NAMES}
    need = set(range(ni))
    for name in ("a_query", "b_g1_query", "b_g2_query"):
        need |= {i for i in idx[name] if i < nv}
    need |= {ni + i for i in idx["l_query"] if i < nv - ni}
    cols = column_scalars(comp, need, tau, d)
    g_inv, d_inv = pow(gamma, -1, P), pow(delta, -1, P)
    z_tau = (pow(tau, d, P) - 1) % P

    def combo(v):
        u, vv, w = cols[v]
        return (beta * u + alpha * vv + w) % P

    scalar = {
        "a_query": lambda i: cols[i][0],
        "b_g1_query": lambda i: cols[i][1],
        "b_g2_query": lambda i: cols[i][1],
        "l_query": lambda i: combo(ni + i) * d_inv % P,
        "h_query": lambda i: pow(tau, i, P) * z_tau % P * d_inv % P,
    }
    out = {}
    for name in QUERY_NAMES:
        kind = "g2" if name == "b_g2_query" else "g1"
        want = [gen_mul(kind, scalar[name](i)) if i < valid[name] else None
                for i in idx[name]]
        out[name] = key_points(kind, getattr(pk, name), idx[name]) == want
    w1, w2 = keygen.g1_wire, keygen.g2_wire
    out["vk_ic"] = vk.ic == [w1(gen_mul("g1", combo(v) * g_inv % P))
                             for v in range(ni)]
    out["vk_head"] = (
        (vk.alpha_g1, vk.beta_g1, vk.delta_g1)
        == tuple(w1(gen_mul("g1", x)) for x in (alpha, beta, delta))
        and (vk.beta_g2, vk.gamma_g2, vk.delta_g2)
        == tuple(w2(gen_mul("g2", x)) for x in (beta, gamma, delta))
        and (w1(pk.alpha_g1), w1(pk.beta_g1), w1(pk.delta_g1),
             w2(pk.beta_g2), w2(pk.delta_g2))
        == (vk.alpha_g1, vk.beta_g1, vk.delta_g1, vk.beta_g2, vk.delta_g2))
    return out, sum(len(v) for v in idx.values())


# ------------------------------------------------------------- the phases


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def peak_requested():
    """Peak of the bytes the tensors asked for since the last reset of the
    peak stats: `max_memory_allocated` less the caching allocator's
    rounding and the unsplit remainders of reused blocks (up to 1 MiB
    each), which depend on what was allocated and freed before."""
    return torch.cuda.memory_stats().get("requested_bytes.all.peak")


def random_field_limbs(F, n: int, gen, device):
    """(n, F.n) canonical limbs: random 16-bit limbs, top limb below p's."""
    x = torch.randint(0, 1 << 16, (n, F.n), generator=gen, device=device,
                      dtype=torch.int32)
    top = (F.p >> (16 * (F.n - 1))) & 0xFFFF
    x[:, -1] = torch.randint(0, top, (n,), generator=gen, device=device,
                             dtype=torch.int32)
    return x


def check_kernel(name, size, launches, run_kernel, run_plain, nbytes, imads,
                 reps=20, timed=None, extra=None):
    """One kernel at one launch size: bit-exact against the plain version,
    then timed (`timed`, where the checked call does more than the
    kernel's launch, else `run_kernel`).  `launches` is how often the
    proof launched this size; `extra` adds keys to the row."""
    out_k = run_kernel()
    out_p = run_plain()
    torch.cuda.synchronize()
    err = int((out_k.to(torch.int64) - out_p.to(torch.int64)).abs().max())
    ms = cuda_ms(timed or run_kernel, reps)
    plain_ms = cuda_ms(run_plain, 2)
    bound_ms, bound_by = bound(nbytes, imads)
    row = {"phase": "kernel", "name": name, "size": list(size),
           "launches": launches, "max_abs_err": float(err), "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           **(extra or {})}
    emit(row)
    if err != 0:
        raise SystemExit(f"{name} at {size}: kernel disagrees with its "
                         "plain version")
    return row


def summarize(rows):
    """A kernel's per-size rows -> its times per launch averaged over the
    proof, each size weighted by how often the proof launched it."""
    n = sum(r["launches"] for r in rows)
    out = {k: sum(r[k] * r["launches"] for r in rows) / n
           for k in ("ms", "plain_ms", "bound_ms")}
    by_bytes = sum(r["bound_ms"] * r["launches"] for r in rows
                   if r["bound_by"] == "bytes")
    out["bound_by"] = ("bytes" if 2 * by_bytes >= out["bound_ms"] * n
                       else "operations")
    out["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    out["library_ms"] = None
    out["sizes"] = len(rows)
    return out


# per group: (kernel, wrapper, plain version, Fp multiplies per lane) for
# affine Q, then for projective Q
CURVE_KERNELS = {
    "g1": ((ck.K_G1_MADD, ck.madd_select_lm, ck.madd_select_lm_plain, 11),
           (ck.K_G1_ADD, ck.add_select_lm, ck.add_select_lm_plain, 12)),
    "g2": ((ck.K_G2_MADD, ck.madd_select_g2_lm, ck.madd_select_g2_lm_plain,
            33),
           (ck.K_G2_ADD, ck.add_select_g2_lm, ck.add_select_g2_lm_plain, 36)),
}


# K6/K7: (kernel, wrapper, plain version, group, Fp multiplies per lane)
FULL_ADD_KERNELS = (
    (ck.K_G1_FULL, ck.g1_add_lm, ck.g1_add_lm_plain, "g1", 12),
    (ck.K_G2_FULL, ck.g2_add_lm, ck.g2_add_lm_plain, "g2", 36),
)
FULL_ADD_NAMES = tuple(k[0].name for k in FULL_ADD_KERNELS)
# lane counts at which K6/K7 are always replayed: keygen's GEN_CHUNK and
# one less (K6's replay time at these two was bimodal on its first port)
FULL_ADD_ALWAYS = (keygen.GEN_CHUNK - 1, keygen.GEN_CHUNK)
K1_NAMES = (fk.K_FR.name, fk.K_FP.name, fk.K_NTT.name, fk.K_INV.name)
# the kernels each driven path must have launched (keygen runs no NTT)
PROOF_KERNELS = K1_NAMES + tuple(k[0].name for group in CURVE_KERNELS.values()
                                 for k in group)
KEYGEN_KERNELS = (fk.K_FR.name, fk.K_FP.name, fk.K_INV.name) + FULL_ADD_NAMES
# 32-bit multiply-adds that z^(p - 2) over Fp needs per element, at the
# least: as many squarings as p - 2 has bits less one, and one multiply
# per sliding 4-bit window (the windows' table of odd powers, part of the
# kernel's own chain, is not counted).
INV_FP_IMADS = ((fp_field().p - 2).bit_length() - 1) * mont_sqr_imads(
    FP_LIMBS) + len(fk.fermat_windows(fp_field().p - 2)[1]) * mont_mul_imads(
    FP_LIMBS)


def k1_operands(F, n: int, b_rows: int, gen, device):
    """Random canonical operands of a K1 launch over n elements whose b has
    b_rows rows, shaped as the proof hands them to the wrapper: a viewed
    (n / b_rows, b_rows, limbs) against b (b_rows, limbs), so b repeats
    over a's leading axis (constants, coset scales) or not.  Among them
    0, (p − 1)², and R − 1 (every limb 0xFFFF) against a canonical row
    in each operand: K1 takes one operand below R, as the row
    evaluation's redundant sums are."""
    a = random_field_limbs(F, n, gen, device)
    b = random_field_limbs(F, b_rows, gen, device)
    p_minus_1 = to_torch(int_to_limbs(F.p - 1, F.n), device)
    a[-1] = p_minus_1  # (p − 1)², the largest canonical product
    b[-1] = p_minus_1
    if n > 1:
        a[0] = 0
    if n > 2:
        a[1] = 0xFFFF  # against b[1 % b_rows], canonical
    if b_rows > 3:
        b[2] = 0xFFFF  # against a[2 + k b_rows], canonical
    return a.view(n // b_rows, b_rows, F.n), b


def ntt_operands(n: int, gen, device):
    """Random canonical Fr limbs for the NTT's stages at size n, with 0 and
    p − 1 among them, and the forward transform's packed twiddles."""
    F = fr_field()
    x = random_field_limbs(F, n, gen, device)
    x[0] = 0
    x[-1] = to_torch(int_to_limbs(F.p - 1, F.n), device)
    log_n = n.bit_length() - 1
    return x, ntt_mod._stage_twiddles(log_n, False, str(device))


def inv_operands(n: int, gen, device):
    """Random canonical Fp limbs for the inversion, the first of them
    p − 1, 1, one in Montgomery form (R mod p) and 0, as many as fit."""
    F = fp_field()
    x = random_field_limbs(F, n, gen, device)
    edges = [F.p - 1, 1, F.R_mod_p, 0]
    for i, v in enumerate(edges[:n]):
        x[i] = to_torch(int_to_limbs(v, F.n), device)
    return x


def curve_operands(kind: str, n_lanes: int, gen, device):
    """Limb-major P (projective), affine Q, projective Q and a mask over
    n_lanes lanes: random valid points plus the cases RCB15 must handle,
    P = identity, P = Q, P = −Q, Q = identity and masked-off lanes."""
    lane = torch.arange(n_lanes, device=device)
    q_proj = prefix_points(kind, 3, 5, n_lanes, device)
    p_proj = prefix_points(kind, 7, 11, n_lanes, device)
    q_aff = lm_to_am(kind, q_proj)[0].permute(1, 2, 0).contiguous()
    y = slice(1, 2) if kind == "g1" else slice(2, 4)
    ident = broadcast_lanes(kind, None, n_lanes, True, device)
    acc = p_proj.clone()
    acc[:, :, 0::8] = ident[:, :, 0::8]             # P = identity
    acc[:, :, 1::8] = q_proj[:, :, 1::8]            # P = Q: doubling
    neg = q_proj[:, :, 2::8].clone()                # P = −Q
    neg[y] = fp_field().neg(neg[y].transpose(1, 2)).transpose(1, 2)
    acc[:, :, 2::8] = neg
    q_with_id = q_proj.clone()
    q_with_id[:, :, 4::8] = ident[:, :, 4::8]       # Q = identity
    mask = (lane % 8 != 3) & (torch.rand(
        n_lanes, generator=gen, device=device) < 0.9)  # masked-off lanes
    return acc, q_aff, q_with_id, mask


def stress_lanes(acc, q, mask):
    """Copies of a curve add's operands (Q affine or projective) with the
    top of the range: in lanes 5 mod 8 every coordinate of acc and Q is
    p − 1, in lanes 6 mod 8 the planes alternate p − 1 and 0, and both are
    active.  These points are off the curve, but RCB15 is one polynomial
    map, so the kernel must still equal its plain version; they are where
    a lazy reduction would overflow."""
    F = fp_field()
    pm1 = to_torch(int_to_limbs(F.p - 1, F.n), acc.device)[:, None]
    acc, q, mask = acc.clone(), q.clone(), mask.clone()
    for x in (acc, q):
        x[:, :, 5::8] = pm1
        for plane in range(x.shape[0]):
            x[plane, :, 6::8] = pm1 if plane % 2 == 0 else 0
    mask[5::8] = True
    mask[6::8] = True
    return acc, q, mask


def kernel_phase(sizes: dict, device):
    """Replay every kernel at each size `sizes` (from the driven paths)
    holds."""
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    rows = {}
    for F, kern in ((fr_field(), fk.K_FR), (fp_field(), fk.K_FP)):
        per = []
        for (n, b_rows), count in sorted(sizes[kern.name].items()):
            a, b = k1_operands(F, n, b_rows, gen, device)
            per.append(check_kernel(
                kern.name, (n, b_rows), count,
                lambda: fk.mont_mul(F, a, b),
                lambda: fk.mont_mul_plain(F, a, b),
                (2 * n + b_rows) * F.n * 4, n * mont_mul_imads(F.n)))
        rows[kern.name] = summarize(per)

    F = fr_field()
    per = []
    for (n, _), count in sorted(sizes[fk.K_NTT.name].items()):
        x, tw = ntt_operands(n, gen, device)
        work = x.clone()
        passes = 1 + max(n.bit_length() - 1 - fk.NTT_LOW_LOG, 0)
        row_bytes = F.n * 4
        per.append(check_kernel(
            fk.K_NTT.name, (n,), count,
            lambda: fk.ntt_stages_(x.clone(), tw),
            lambda: fk.ntt_stages_plain(x, tw),
            (3 * n - 1) * row_bytes, ntt_imads(n), reps=5,
            timed=lambda: fk.ntt_stages_(work, tw),
            # a diagnostic, not a bound of the function: the bytes of the
            # kernel's own passes, each reading and writing every row
            extra={"passes": passes, "diag_passes_bytes_ms": bound(
                (2 * passes * n + n - 1) * row_bytes, 0)[0]}))
    rows[fk.K_NTT.name] = summarize(per)

    F = fp_field()
    per = []
    for (n, _), count in sorted(sizes[fk.K_INV.name].items()):
        x = inv_operands(n, gen, device)
        per.append(check_kernel(
            fk.K_INV.name, (n,), count,
            lambda: fk.mont_inv(F, x), lambda: fk.mont_inv_plain(F, x),
            2 * n * F.n * 4, n * INV_FP_IMADS,
            reps=5))
    rows[fk.K_INV.name] = summarize(per)

    for kind in ("g1", "g2"):
        kerns = CURVE_KERNELS[kind]
        n_max = max(L for k in kerns for L, _ in sizes[k[0].name])
        acc, q_aff, q_with_id, mask = curve_operands(kind, n_max, gen, device)
        for (kern, api, plain, n_mul), q_k in zip(kerns, (q_aff, q_with_id)):
            acc_k, q, mask_k = stress_lanes(acc, q_k, mask)
            per = []
            for (L, _), count in sorted(sizes[kern.name].items()):
                acc_l = acc_k[:, :, :L].contiguous()
                q_l = q[:, :, :L].contiguous()
                mask_l = mask_k[:L].contiguous()
                active = int(mask_l.sum())
                # acc read and out written in every lane, Q read where active
                nbytes = (L * (2 * acc.shape[0] * FP_LIMBS * 4 + 1)
                          + active * q.shape[0] * FP_LIMBS * 4)
                per.append(check_kernel(
                    kern.name, (L,), count,
                    lambda: api(acc_l, q_l, mask_l),
                    lambda: plain(acc_l, q_l, mask_l),
                    nbytes, active * n_mul * mont_mul_imads(FP_LIMBS),
                    reps=10))
            rows[kern.name] = summarize(per)

    for kern, api, plain, kind, n_mul in FULL_ADD_KERNELS:
        # keygen's chunk and one lane short of it, whatever the run's
        # sizes; a size no phase launched weighs nothing in the averages
        replay = {(n, 0): 0 for n in FULL_ADD_ALWAYS}
        replay.update(sizes[kern.name])
        n_max = max(L for L, _ in replay)
        # P: identity, P = Q, P = −Q in some lanes; Q: identity in others;
        # Z ≠ 1 on both sides elsewhere; then every coordinate p − 1 or
        # alternating p − 1 and 0 in lanes 5 and 6 mod 8
        p_pts, _, q_pts, _ = curve_operands(kind, n_max, gen, device)
        p_pts, q_pts, _ = stress_lanes(
            p_pts, q_pts, torch.ones(n_max, dtype=torch.bool, device=device))
        per = []
        for (L, _), count in sorted(replay.items()):
            p_l = p_pts[:, :, :L].contiguous()
            q_l = q_pts[:, :, :L].contiguous()
            per.append(check_kernel(
                kern.name, (L,), count,
                lambda: api(p_l, q_l), lambda: plain(p_l, q_l),
                3 * L * p_pts.shape[0] * FP_LIMBS * 4,
                L * n_mul * mont_mul_imads(FP_LIMBS), reps=10))
        rows[kern.name] = summarize(per)
    return rows


def merge_phases(*phases):
    """Launch counts and sizes of several phases, summed per kernel."""
    launches = {name: sum(p[0][name] for p in phases)
                for name in _cuda.REGISTRY}
    sizes = {}
    for name in _cuda.REGISTRY:
        merged = {}
        for _, sz in phases:
            for key, count in sz[name].items():
                merged[key] = merged.get(key, 0) + count
        sizes[name] = merged
    return launches, sizes


def toy_circuit(x: int = 3, y: int = 5):
    """The committed toy key's circuit: public z = x·y, witness x, y and
    s = x + y (2 constraints).  Returns (cs, z)."""
    cs = ConstraintSystem(proving=True)
    z = x * y % P
    z_var = cs.alloc_input(z)
    x_var = cs.alloc(x)
    y_var = cs.alloc(y)
    cs.enforce(lc((x_var, 1)), lc((y_var, 1)), lc((z_var, 1)))
    s_var = cs.alloc(x + y)
    cs.enforce(lc((x_var, 1), (y_var, 1)), lc((ONE, 1)), lc((s_var, 1)))
    return cs, z


def toy_phase(device):
    params = keygen.load_parameters(TOY_KEY, device=device)
    cs, z = toy_circuit()
    t0 = time.perf_counter()
    proof = prove.create_proof(params, cs, r=7, s=11, device=device)
    seconds = time.perf_counter() - t0
    same = ser.dumps(proof).hex() == TOY_PROOF_HEX
    verdicts = [groth16_verify(params.vk, inp, proof)
                for inp in ([z], [z + 1], [z, 0])]
    emit({"phase": "toy", "seconds": seconds, "bytes_equal_jax": same,
          "verify_accepts_z": verdicts[0],
          "verify_rejects_z_plus_1": not verdicts[1],
          "verify_rejects_two_inputs": not verdicts[2]})
    if not (same and verdicts == [True, False, False]):
        raise SystemExit("toy proof disagrees with the JAX package")


def constraints_for(log_d: int) -> int:
    """The MPN batch-64 constraint count scaled to a d = 2^log_d domain."""
    if log_d <= 22:
        return MPN_B64_CONSTRAINTS >> (22 - log_d)
    return MPN_B64_CONSTRAINTS << (log_d - 22)


def real_size_setup(log_d: int, device, seed: int = ROOT_SEED):
    """The synthetic circuit and key for a d = 2^log_d proof."""
    n_cons = constraints_for(log_d)
    cs = SyntheticCircuit(n_cons, seed)
    comp = cs.compiled()
    d = qap.domain_size(n_cons, comp.num_inputs)
    params, sc = synthetic_params(comp.num_vars, comp.num_inputs, d, seed,
                                  device)
    return cs, params, sc, d


def check_real_proof(cs, params, sc, d, proof, record, r, s, rho):
    """Every check of phase 4; returns a dict of verdicts."""
    F = fr_field()
    h_std = record["h_std"]
    h_ints = [int(v) for v in np.atleast_1d(F.decode(h_std, mont=False))]
    A, B, C = expected_proof(cs.z, h_ints, params.pk.num_inputs, sc, r, s)
    return {
        "a_equal_host": proof.a == keygen.g1_wire(A),
        "b_equal_host": proof.b == keygen.g2_wire(B),
        "c_equal_host": proof.c == keygen.g1_wire(C),
        "h_identity": h_identity_holds(cs.compiled(), cs.z, h_std, d, rho),
    }


def proof_phase(log_d: int, device):
    t0 = time.perf_counter()
    cs, params, sc, d = real_size_setup(log_d, device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    comp = cs.compiled()
    Np = params.pk.a_query[0].shape[0]
    r, s = 1234567, 7654321
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_counts()
    record = {}
    t1 = time.perf_counter()
    proof = prove.create_proof(params, cs, r=r, s=s, device=device,
                               record=record)
    torch.cuda.synchronize()
    total = time.perf_counter() - t1
    launches = _cuda.counts()
    sizes = _cuda.sizes()
    peak = torch.cuda.max_memory_allocated()
    requested = peak_requested()
    rho = int.from_bytes(np.random.default_rng(ROOT_SEED).bytes(32),
                         "little") % P
    checks = check_real_proof(cs, params, sc, d, proof, record, r, s, rho)
    emit({"phase": "proof", "log_d": log_d, "d": d, "Np": Np,
          "n_constraints": comp.n_constraints, "num_vars": comp.num_vars,
          "n_terms": [int(a.shape[0]) for a in comp.rows],
          "n_heavy_vals": record["n_heavy_vals"], "setup_s": setup_s,
          "stage_s": record["seconds"], "total_s": total,
          "max_memory_allocated": peak,
          "max_memory_requested": requested, "launches": launches, **checks})
    if not all(checks.values()):
        raise SystemExit(f"real-size proof failed its checks: {checks}")
    require_launched("proof", PROOF_KERNELS, launches)
    drain_profile(params, cs, device)
    h_profile(params, cs, d, device)
    return launches, sizes


# device kernel name -> kernel row, for the profile of the drain: a key
# matches where "::" + key is in the name, so it starts at the function's
# own name ("add_select_kernel<..." would not match "madd_select_kernel<...")
PROFILED_KERNELS = (
    ("madd_select_kernel<bz::lazy::G1Lazy", ck.K_G1_MADD.name),
    ("madd_select_kernel<bz::lazy::G2Lazy", ck.K_G2_MADD.name),
    ("proj_add_select_kernel<bz::lazy::G1Lazy", ck.K_G1_ADD.name),
    ("proj_add_select_kernel<bz::lazy::G2Lazy", ck.K_G2_ADD.name),
    ("proj_add_kernel<bz::lazy::G1Lazy", ck.K_G1_FULL.name),
    ("proj_add_kernel<bz::lazy::G2Lazy", ck.K_G2_FULL.name),
    ("mont_mul_kernel", "mont_mul"),
    ("mont_inv_fp_kernel", fk.K_INV.name),
    ("ntt_low_kernel", fk.K_NTT.name),
    ("ntt_stage_kernel", fk.K_NTT.name),
)


def profiled_row(device_name: str) -> str:
    """The kernel row of a device kernel's name, or "other"."""
    return next((row for key, row in PROFILED_KERNELS
                 if "::" + key in device_name), "other")


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


# "other" device time is also broken down by name, the longest first
OTHER_NAMES = 12
OTHER_NAME_CHARS = 160


def profiled_run(run, fresh=tuple) -> dict:
    """`run(*fresh())` timed alone, then under torch.profiler (CPU and CUDA
    activities): device time by kernel row, the "other" row's by device
    kernel name (the longest OTHER_NAMES, names cut to OTHER_NAME_CHARS),
    launches, and the device's idle share, one minus the union of device
    activity over the wall time of the call closed by a synchronise.  The profiler slows the host's launches,
    so `idle_share` takes the unprofiled call's wall time and
    `idle_share_profiled` the profiled one's.  Where the profiler records no
    device activity, CUDA events around the whole call stand in, and the
    row says so.  `fresh` makes the arguments outside the timed region."""
    from torch.profiler import ProfilerActivity, profile

    args = fresh()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(*args)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    args = fresh()
    torch.cuda.synchronize()
    _cuda.reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(*args)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    launches = {k: v for k, v in _cuda.counts().items() if v}
    by_kernel, by_name, spans = {}, {}, []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((evt.time_range.start, evt.time_range.end))
        row = profiled_row(evt.name)
        us = evt.time_range.end - evt.time_range.start
        by_kernel[row] = by_kernel.get(row, 0.0) + us
        if row == "other":
            name = evt.name[:OTHER_NAME_CHARS]
            by_name[name] = by_name.get(name, 0.0) + us
    out = {"wall_s": wall_s, "wall_profiled_s": wall_us / 1e6,
           "launches": launches}
    if spans:
        busy = _busy_us(spans)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:OTHER_NAMES]
        out.update(source="torch.profiler",
                   device_s={k: v / 1e6 for k, v in by_kernel.items()},
                   other_by_name_s={k: v / 1e6 for k, v in top},
                   device_busy_s=busy / 1e6,
                   idle_share=1 - busy / (wall_s * 1e6),
                   idle_share_profiled=1 - busy / wall_us)
    else:
        args = fresh()
        t_a = torch.cuda.Event(enable_timing=True)
        t_b = torch.cuda.Event(enable_timing=True)
        t_a.record()
        run(*args)
        t_b.record()
        t_b.synchronize()
        out.update(source="cuda_events (the profiler saw no device "
                          "activity)",
                   events_s=t_a.elapsed_time(t_b) / 1e3)
    return out


def _witness(params, cs, device):
    """The proof's (Np, 16) standard-form witness limbs: numpy and device."""
    comp = cs.compiled()
    z_np = np.zeros((params.pk.a_query[0].shape[0], 16), np.uint32)
    z_np[:comp.num_vars] = ints_to_array(
        [v % P for v in cs.full_assignment()], 16)
    return z_np, to_torch(z_np, device)


def drain_profile(params, cs, device):
    """`msm_a` and `msm_b_g2` of the proof once more, each through
    `profiled_run`: device time by kernel (K2-K5, K1, the rest) and idle
    share."""
    pk = params.pk
    z_np, z_std = _witness(params, cs, device)
    plan = msm_lm.make_dedup_plan(z_np)
    c = prove._msm_c(pk.a_query[0].shape[0])
    for stage, query, run in (("msm_a", pk.a_query, msm_lm.msm_lm),
                              ("msm_b_g2", pk.b_g2_query, msm_lm.msm_lm_g2)):
        emit({"phase": "drain_profile", "stage": stage,
              **profiled_run(lambda: run(query[0], query[1], z_std, c=c,
                                         dedup_plan=plan))})


def h_profile(params, cs, d, device):
    """The proof's h phase (`compute_h_mont`: 7 NTTs and the pointwise
    products) once more on the proof's row evaluations, without the
    dedup-plan thread that runs beside it in the proof: first with the NTT
    tables dropped, so that it builds them as the proof's first h phase
    does (`cold_tables_s`), then through `profiled_run`."""
    z_mont = fr_field().to_mont(_witness(params, cs, device)[1])
    dr = params.dev_r1cs

    def evs():
        return ([prove._pad_rows(p.eval(z_mont, dr.pal_mont), d)
                 for p in dr.row_plans],)

    def h(e):
        return prove.compute_h_mont(e, d)

    ntt_mod._stage_twiddles.cache_clear()
    ntt_mod._coset_scale.cache_clear()
    args = evs()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h(*args)
    torch.cuda.synchronize()
    emit({"phase": "h_profile", "cold_tables_s": time.perf_counter() - t0,
          **profiled_run(h, evs)})


def gen_mul_profile(device):
    """One `_gen_mul_am` chunk of GEN_CHUNK random scalars on G1 and one
    on G2 (the window tables already built), each through `profiled_run`:
    device time of K6/K7, K1's Fp multiply and inversion, and the rest by
    PyTorch kernel name (`_kernel_add`'s stacks and transposes, `_gather`,
    the affine conversion's); idle share."""
    gen = torch.Generator(device=device)
    gen.manual_seed(ROOT_SEED)
    scalars = random_field_limbs(fr_field(), keygen.GEN_CHUNK, gen, device)
    for kind in ("g1", "g2"):
        keygen._gen_mul_am(scalars, kind)  # the allocator's growth, untimed
        emit({"phase": "gen_mul_profile", "group": kind,
              "scalars": keygen.GEN_CHUNK,
              **profiled_run(lambda: keygen._gen_mul_am(scalars, kind))})


def require_launched(phase: str, names, launches: dict):
    missing = [k for k in names if launches[k] == 0]
    if missing:
        raise SystemExit(f"kernels not launched by the {phase}: {missing}")


def keygen_phase(log_d: int, device):
    """The 2^log_d key of the synthetic circuit, counted from a cold start
    (the window tables are built in it): spot-checked, proven under and
    verified; then the toy key against the committed file; then
    `gen_mul_profile`."""
    cs = SyntheticCircuit(constraints_for(log_d), ROOT_SEED)
    comp = cs.compiled()
    d = qap.domain_size(comp.n_constraints, comp.num_inputs)
    seed = b"bazuka-tpu-dev"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_counts()
    record = {}
    t1 = time.perf_counter()
    params = keygen.generate_parameters(cs, seed=seed, device=device,
                                        record=record)
    torch.cuda.synchronize()
    total = time.perf_counter() - t1
    launches = _cuda.counts()
    sizes = _cuda.sizes()
    peak = torch.cuda.max_memory_allocated()
    requested = peak_requested()
    Np = params.pk.a_query[0].shape[0]

    t2 = time.perf_counter()
    samples, n_sampled = key_spot_check(comp, params, seed, d)
    check_s = time.perf_counter() - t2
    proof_record = {}
    t3 = time.perf_counter()
    proof = prove.create_proof(params, cs, r=1234567, s=7654321,
                               device=device, record=proof_record)
    torch.cuda.synchronize()
    proof_s = time.perf_counter() - t3
    x = cs.z[1]
    verdicts = (groth16_verify(params.vk, [x], proof),
                groth16_verify(params.vk, [(x + 1) % P], proof))
    del params
    torch.cuda.empty_cache()

    cs_toy, _ = toy_circuit()
    t4 = time.perf_counter()
    toy = keygen.generate_parameters(cs_toy, seed=b"test", device=device)
    toy_s = time.perf_counter() - t4
    toy_eq = key_equals_file(toy, TOY_KEY)
    checks = {
        **{f"toy_{k}": v for k, v in toy_eq.items()},
        **samples,
        "verify_accepts_x": verdicts[0],
        "verify_rejects_x_plus_1": not verdicts[1],
    }
    emit({"phase": "keygen", "log_d": log_d, "d": d,
          "Np": Np,
          "n_constraints": comp.n_constraints, "num_vars": comp.num_vars,
          "toy_s": toy_s, "stage_s": record["seconds"], "total_s": total,
          "max_memory_allocated": peak,
          "max_memory_requested": requested, "launches": launches,
          "add_sizes": {k: {str(n): c for (n, _), c in sorted(sizes[k].items())}
                        for k in FULL_ADD_NAMES},
          "rows_sampled": n_sampled, "spot_check_s": check_s,
          "proof_stage_s": proof_record["seconds"], "proof_total_s": proof_s,
          **checks})
    if not all(checks.values()):
        raise SystemExit(f"keygen failed its checks: {checks}")
    require_launched("keygen", KEYGEN_KERNELS, launches)
    gen_mul_profile(device)
    return launches, sizes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-d", type=int, default=22,
                    help="log2 of the real-size proof's and key's domain "
                         "(default 22)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    logs = _cuda.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(logs)})
    for src, log in logs.items():
        for line in log.splitlines():
            if ("entry function" in line or "registers" in line
                    or "spill" in line):
                print(f"  [{src}] {line.strip()}", flush=True)

    toy_phase(device)
    proof_run = proof_phase(args.log_d, device)
    torch.cuda.empty_cache()  # the synthetic key is gone before keygen
    keygen_run = keygen_phase(args.log_d, device)
    torch.cuda.empty_cache()
    launches, sizes = merge_phases(proof_run, keygen_run)
    rows = kernel_phase(sizes, device)

    kernels = []
    for name, k in _cuda.REGISTRY.items():
        row = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"bazuka_tpu_torch/csrc/{k.source}",
            "replaces": k.replaces, "launches": launches[name],
            "launches_by_phase": {"proof": proof_run[0][name],
                                  "keygen": keygen_run[0][name]},
            **{key: row[key] for key in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms", "sizes")},
        })
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
