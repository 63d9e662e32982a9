"""Groth16 parameters on the card: generation, types, saving and loading
(port of `bazuka_tpu/groth16/keygen.py`).

`generate_parameters` is the reference's in-process `--dev` keygen
(deterministic from a seed):
  1. L_j(τ) over the domain on the host (`qap.lagrange_at`), then
     u_i(τ), v_i(τ), w_i(τ) per variable by the sparse column evaluation
     (`sparse.DeviceR1CS.eval_cols`: gather, K1, `index_add_`)
  2. the per-variable scalar algebra ((βu+αv+w)/γ or /δ) as batched
     Montgomery multiplies on the device; the h scalars τ^i·Z(τ)/δ on the
     host
  3. every key point is scalar·G1 or scalar·G2: the windowed fixed-base
     multiply (`ops.weierstrass.batch_gen_mul`, 32 complete adds per
     scalar, K6/K7 on the card) in chunks of GEN_CHUNK, each chunk turned
     to affine by one batched Fermat inversion (K1) and written into its
     query's rows, on the card or on the host

A query is a pair (affine Montgomery limbs, infinity flags): (Np, 2, 24)
for G1, (Np, 4, 24) for G2, and (Np,).  Rows past each query's length, and
points at infinity, are zero limbs with the flag set, as the JAX package
writes them.  Where it lives is the `device_queries` policy of the JAX
package (`bazuka_tpu/groth16/keygen.py:295-320`): True keeps all five on
the card, "g1" the four G1 queries (the G2 query on the host), False none;
by default True up to Np = RESIDENT_ALL_MAX, "g1" up to RESIDENT_G1_MAX,
False above (the mainnet batch-256 key, Np = 2^24).  A query on the card
is narrow (int16 limbs, uint8 flags: `fields.limbs.narrow_limbs`), half
the bytes of the kernels' int32 form, and the prover widens it per MSM; a
query on the host is uint16/uint8 numpy (a loaded directory key's memory
maps), which the prover uploads narrow per MSM.  A key built another way
may hold wide int32 limbs and bool flags on the card; the prover takes
those as they are.  Singleton points are host affine tuples.

Keys written by either package load in both.  Both layouts (one `.npz`, or
a directory of narrow `.npy` files with `head.pkl`) pickle their header
with the JAX package's class names: this package writes its three wire
classes under those names without importing them, and reads them back with
an unpickler that maps the names to its own classes and refuses any other
class.  The JAX package's `backend=` option is not ported.
"""

from __future__ import annotations

import hashlib
import io
import os
import pickle
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..crypto import bls12_381 as bls
from ..device import resolve_device
from ..fields.limbs import (FP_LIMBS, fp_field, fr_field, narrow_limbs,
                            narrow_np, narrow_to_device, to_numpy)
from ..ops import weierstrass as wst
from ..ops.msm_lm import msm_pad_len
from ..utils import spans
from ..zk.proof import G1Wire, G2Wire, Groth16VerifyingKey
from . import qap
from .sparse import DeviceR1CS, encode_mont

R = bls.R

GEN_CHUNK = 1 << 16  # fixed-base multiplies per chunk (bounds live memory)

# The default residency of a key's queries by their padded length Np
# (bazuka_tpu/groth16/keygen.py:311-318): module constants, so that a run
# at a toy size can lower them.
RESIDENT_ALL_MAX = 1 << 22
RESIDENT_G1_MAX = 1 << 23


def default_residency(Np: int):
    """The `device_queries` value for a key of padded length Np."""
    if Np <= RESIDENT_ALL_MAX:
        return True
    return "g1" if Np <= RESIDENT_G1_MAX else False


def _resident(device_queries, name: str) -> bool:
    """Whether query `name` lives on the card under `device_queries`."""
    if name == "b_g2_query":
        return device_queries is True
    return bool(device_queries)


def _rng_scalars(seed: bytes, n: int, tag: bytes) -> List[int]:
    """Deterministic nonzero Fr scalars from a seed (SHA3 stream)."""
    out = []
    counter = 0
    while len(out) < n:
        h = hashlib.sha3_256(seed + tag + counter.to_bytes(8, "little")).digest()
        v = int.from_bytes(h, "little") % R
        if v != 0:
            out.append(v)
        counter += 1
    return out


@dataclass
class ProvingKey:
    alpha_g1: bls.G1Point
    beta_g1: bls.G1Point
    beta_g2: bls.G2Point
    delta_g1: bls.G1Point
    delta_g2: bls.G2Point
    a_query: object  # ((Np, 2, 24) affine, (Np,) inf mask)
    b_g1_query: object  # ((Np, 2, 24), (Np,))
    b_g2_query: object  # ((Np, 4, 24) Fp2 affine, (Np,) inf mask)
    h_query: object  # ((Np, 2, 24), (Np,))
    l_query: object  # ((Np, 2, 24), (Np,)) — aux slots first
    num_inputs: int = 0


@dataclass
class Parameters:
    pk: ProvingKey
    vk: Groth16VerifyingKey
    dev_r1cs: Optional[DeviceR1CS] = field(default=None, repr=False)


def g1_wire(p: bls.G1Point) -> G1Wire:
    if p is None:
        return G1Wire(0, 1, True)
    return G1Wire(p[0], p[1], False)


def g2_wire(p: bls.G2Point) -> G2Wire:
    if p is None:
        return G2Wire((0, 0), (1, 0), True)
    return G2Wire(p[0], p[1], False)


def wire_g1(w: G1Wire) -> bls.G1Point:
    return None if w.infinity else (w.x, w.y)


def wire_g2(w: G2Wire) -> bls.G2Point:
    return None if w.infinity else (tuple(w.x), tuple(w.y))


# ------------------------------------------------------------ generation


def _gen_mul_am(scalars_std, kind: str, out_am=None, out_inf=None):
    """Streamed fixed-base multiply (the port of `_gen_mul_am_host`):
    (M, 16) standard-form scalars -> point-major affine rows.  Each
    GEN_CHUNK batch is multiplied, inverted to affine and written into
    rows [lo, lo + n) of out_am/out_inf: int32 limbs and bool flags on the
    scalars' device (allocated if not given), or narrow ones given by the
    caller, int16/uint8 on the device or uint16/uint8 numpy on the host.
    The JAX package pads every chunk to a fixed shape for its compiled
    programs; these kernels take any lane count, so the last chunk runs at
    its own size.  Returns (out_am, out_inf)."""
    M = int(scalars_std.shape[0])
    dev = scalars_std.device
    if out_am is None:
        n_aff = 2 if kind == "g1" else 4
        out_am = torch.zeros((M, n_aff, FP_LIMBS), dtype=torch.int32,
                             device=dev)
        out_inf = torch.ones((M,), dtype=torch.bool, device=dev)
    to_am = wst.g1_proj_to_am if kind == "g1" else wst.g2_proj_to_am
    for lo in range(0, M, GEN_CHUNK):
        am, inf = to_am(wst.batch_gen_mul(scalars_std[lo:lo + GEN_CHUNK],
                                          kind))
        hi = lo + am.shape[0]
        if isinstance(out_am, np.ndarray):
            out_am[lo:hi] = to_numpy(narrow_limbs(am))
            out_inf[lo:hi] = inf.cpu().numpy()
        else:
            narrow = out_am.dtype == torch.int16
            out_am[lo:hi] = narrow_limbs(am) if narrow else am
            out_inf[lo:hi] = inf
    return out_am, out_inf


def _decode_g1_am(am, inf) -> List[bls.G1Point]:
    """Point-major affine Montgomery rows -> host affine points."""
    F = fp_field()
    xs = np.atleast_1d(F.decode(am[:, 0, :]))
    ys = np.atleast_1d(F.decode(am[:, 1, :]))
    return [None if i else (int(x), int(y))
            for x, y, i in zip(xs, ys, np.asarray(inf.cpu()))]


def _decode_g2_am(am, inf) -> List[bls.G2Point]:
    F = fp_field()
    c = [np.atleast_1d(F.decode(am[:, k, :])) for k in range(4)]
    return [None if i else ((int(c[0][j]), int(c[1][j])),
                            (int(c[2][j]), int(c[3][j])))
            for j, i in enumerate(np.asarray(inf.cpu()))]


@spans.call("generate_parameters")
def generate_parameters(cs, seed: bytes = b"bazuka-tpu-dev", device="cuda",
                        record: Optional[dict] = None,
                        device_queries=None) -> Parameters:
    """Deterministic Groth16 setup for the circuit recorded in `cs`
    (anything with `compiled()`), equal to the JAX package's
    `generate_parameters(cs, seed)`.  `device_queries` (True, "g1" or
    False; None: `default_residency(Np)`) says which queries stay on the
    card, narrow; the others are written chunk by chunk into host arrays.
    If `record` is a dict it is filled with per-stage seconds (the card
    synchronised at each stage boundary) under "seconds".  The stages are
    spans of the call either way (`utils.spans`); only `record`
    synchronises."""
    dev = resolve_device(device)
    st = spans.Stages("setup", (lambda: torch.cuda.synchronize(dev))
                      if record is not None and dev.type == "cuda" else None)
    comp = cs.compiled()
    dr = DeviceR1CS(comp, dev)
    num_vars, n_inputs = comp.num_vars, comp.num_inputs
    tau, alpha, beta, gamma, delta = _rng_scalars(seed, 5, b"toxic")
    d = qap.domain_size(comp.n_constraints, n_inputs)
    F = fr_field()
    st.next("lagrange_host")

    # Lagrange values at tau over the size-d domain (host), then the
    # column evaluation on the device
    L = qap.lagrange_at(tau, d)
    st.next("col_eval")
    L_mont = encode_mont(L[: dr.n_rows], dev)
    del L
    u_m, v_m, w_m = dr.eval_cols(L_mont)  # (num_vars, 16) mont each
    del L_mont
    st.next("scalar_algebra")

    gamma_inv = pow(gamma, -1, R)
    delta_inv = pow(delta, -1, R)
    z_tau = (pow(tau, d, R) - 1) % R

    # combo_i = beta*u_i + alpha*v_i + w_i; then /gamma (inputs), /delta (aux)
    combo = F.add(F.add(F.mont_mul(u_m, F.const_mont(beta, dev)[None]),
                        F.mont_mul(v_m, F.const_mont(alpha, dev)[None])), w_m)
    ic_std = F.from_mont(F.mont_mul(combo[:n_inputs],
                                    F.const_mont(gamma_inv, dev)[None]))
    l_std = F.from_mont(F.mont_mul(combo[n_inputs:],
                                   F.const_mont(delta_inv, dev)[None]))
    u_std = F.from_mont(u_m)
    v_std = F.from_mont(v_m)
    del u_m, v_m, w_m, combo
    st.next("h_scalars_host")

    # h query scalars: tau^i * Z(tau)/delta, i in 0..d-2 (host geometric)
    h_scalars = []
    acc = z_tau * delta_inv % R
    for _ in range(d - 1):
        h_scalars.append(acc)
        acc = acc * tau % R
    h_std = F.encode(np.array(h_scalars, dtype=object), mont=False,
                     device=dev)
    del h_scalars
    st.next("g1_head_ic")

    # every query has one padded length, the prover's MSM length; each is
    # written chunk by chunk, narrow, where it will live (pad rows:
    # infinity)
    Np = msm_pad_len(max(num_vars, d - 1))
    if device_queries is None:
        device_queries = default_residency(Np)

    def make_query(name, scalars):
        n_aff, kind = (4, "g2") if name == "b_g2_query" else (2, "g1")
        if _resident(device_queries, name):
            am = torch.zeros((Np, n_aff, FP_LIMBS), dtype=torch.int16,
                             device=dev)
            inf = torch.ones((Np,), dtype=torch.uint8, device=dev)
        else:
            am = np.zeros((Np, n_aff, FP_LIMBS), np.uint16)
            inf = np.ones((Np,), np.uint8)
        _gen_mul_am(scalars, kind, am, inf)
        return (am, inf)

    def head(vals):
        return F.encode(np.array(vals, dtype=object), mont=False, device=dev)

    alpha_g1, beta_g1, delta_g1 = _decode_g1_am(
        *_gen_mul_am(head([alpha, beta, delta]), "g1"))
    ic_pts = _decode_g1_am(*_gen_mul_am(ic_std, "g1"))
    st.next("a_query")
    a_query = make_query("a_query", u_std)
    st.next("b_g1_query")
    b_g1_query = make_query("b_g1_query", v_std)
    st.next("l_query")
    l_query = make_query("l_query", l_std)
    st.next("h_query")
    h_query = make_query("h_query", h_std)
    del h_std
    st.next("g2_head_b_g2_query")

    # G2: [beta, gamma, delta] head + the v tail
    beta_g2, gamma_g2, delta_g2 = _decode_g2_am(
        *_gen_mul_am(head([beta, gamma, delta]), "g2"))
    b_g2_query = make_query("b_g2_query", v_std)
    st.end()

    pk = ProvingKey(
        alpha_g1=alpha_g1,
        beta_g1=beta_g1,
        beta_g2=beta_g2,
        delta_g1=delta_g1,
        delta_g2=delta_g2,
        a_query=a_query,
        b_g1_query=b_g1_query,
        b_g2_query=b_g2_query,
        h_query=h_query,
        l_query=l_query,
        num_inputs=n_inputs,
    )
    vk = Groth16VerifyingKey(
        alpha_g1=g1_wire(alpha_g1),
        beta_g1=g1_wire(beta_g1),
        beta_g2=g2_wire(beta_g2),
        gamma_g2=g2_wire(gamma_g2),
        delta_g1=g1_wire(delta_g1),
        delta_g2=g2_wire(delta_g2),
        ic=[g1_wire(p) for p in ic_pts],
    )
    if record is not None:
        record["seconds"] = st.seconds
    return Parameters(pk=pk, vk=vk, dev_r1cs=dr)


# ------------------------------------------------------------ persistence

_QUERY_NAMES = ("a_query", "b_g1_query", "l_query", "h_query", "b_g2_query")

# the JAX package's module and name of each wire class in a key header
_JAX_NAMES = {
    Groth16VerifyingKey: ("bazuka_tpu.zk.proof", "Groth16VerifyingKey"),
    G1Wire: ("bazuka_tpu.zk.proof", "G1Wire"),
    G2Wire: ("bazuka_tpu.zk.proof", "G2Wire"),
}


class _HeadPickler(pickle._Pickler):
    """Writes this package's three wire classes under the JAX package's
    names (the mirror of `_HeadUnpickler`), without importing that
    package, so a header comes out byte for byte as `bazuka_tpu` pickles
    it; refuses every other class.  The pure-Python pickler is used because
    it lets `save_global` be replaced; it writes the same bytes as the C
    pickler."""

    def save_global(self, obj, name=None):
        names = _JAX_NAMES.get(obj)
        if names is None:
            raise pickle.PicklingError(f"refusing {obj!r} in a key header")
        if self.proto < 4:
            raise pickle.PicklingError("key headers use protocol 4 or above")
        self.save(names[0])
        self.save(names[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def _dump_head(head: dict) -> bytes:
    buf = io.BytesIO()
    _HeadPickler(buf, pickle.DEFAULT_PROTOCOL).dump(head)
    return buf.getvalue()


def _pk_head(params: Parameters) -> dict:
    pk = params.pk
    return {
        "alpha_g1": pk.alpha_g1,
        "beta_g1": pk.beta_g1,
        "beta_g2": pk.beta_g2,
        "delta_g1": pk.delta_g1,
        "delta_g2": pk.delta_g2,
        "num_inputs": pk.num_inputs,
        "vk": params.vk,
    }


def _narrow(query):
    """A query, wherever it lives -> (uint16 limbs, uint8 flags) on the
    host: the JAX package's on-disk form."""
    am, inf = query
    if isinstance(am, torch.Tensor):
        am = to_numpy(narrow_limbs(am))
    if isinstance(inf, torch.Tensor):
        inf = inf.cpu().numpy()
    return narrow_np(am), narrow_np(inf)


def save_parameters(params: Parameters, path: str) -> None:
    """Serialize Parameters as `bazuka_tpu.groth16.keygen.save_parameters`
    does: the query tensors (narrow: uint16 limb payloads, uint8 flags) and
    a pickled header with the host singleton points and the VK.

    Two layouts by `path`:
      * `*.npz` — one zip archive;
      * anything else — a directory of `.npy` files and `head.pkl`, which
        loads back memory-mapped."""
    head = _dump_head(_pk_head(params))
    if path.endswith(".npz"):
        arrs = {"head": np.frombuffer(head, np.uint8)}
        for name in _QUERY_NAMES:
            arrs[name + "_am"], arrs[name + "_inf"] = _narrow(
                getattr(params.pk, name))
        np.savez(path, **arrs)
        return
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "head.pkl"), "wb") as f:
        f.write(head)
    for name in _QUERY_NAMES:
        am, inf = _narrow(getattr(params.pk, name))
        np.save(os.path.join(path, name + "_am.npy"), am)
        np.save(os.path.join(path, name + "_inf.npy"), inf)


# ------------------------------------------------------------ loading

_MAPPED = {
    ("bazuka_tpu.zk.proof", "Groth16VerifyingKey"): Groth16VerifyingKey,
    ("bazuka_tpu.zk.proof", "G1Wire"): G1Wire,
    ("bazuka_tpu.zk.proof", "G2Wire"): G2Wire,
}


class _HeadUnpickler(pickle.Unpickler):
    """Maps the key header's wire classes to this package's copies and
    refuses every other class, so loading a key imports nothing."""

    def find_class(self, module, name):
        cls = _MAPPED.get((module, name))
        if cls is None:
            raise pickle.UnpicklingError(
                f"refusing {module}.{name} in a key header")
        return cls


def _load_head(data: bytes) -> dict:
    return _HeadUnpickler(io.BytesIO(data)).load()


def params_from_numpy(head: dict, queries: dict, device="cuda",
                      device_queries=None) -> Parameters:
    """Parameters from host data: `head` holds the singleton points
    (alpha_g1, beta_g1, beta_g2, delta_g1, delta_g2), `num_inputs`, and
    `vk` as wire tuples (the fields of Groth16VerifyingKey in order, each
    point as (x, y, infinity)); `queries` maps each query name to its
    (am, inf) numpy pair, limbs uint16 or uint32.  `device_queries` as in
    `generate_parameters` (None: `default_residency(Np)`): the queries it
    keeps on the card are uploaded narrow, the others stay host arrays,
    narrowed where they are not (a memory map stays one)."""
    dev = resolve_device(device)
    vk = head["vk"]
    if not isinstance(vk, Groth16VerifyingKey):
        a1, b1, b2, g2, d1, d2, ic = vk
        vk = Groth16VerifyingKey(
            G1Wire(*a1), G1Wire(*b1),
            G2Wire(tuple(b2[0]), tuple(b2[1]), b2[2]),
            G2Wire(tuple(g2[0]), tuple(g2[1]), g2[2]),
            G1Wire(*d1),
            G2Wire(tuple(d2[0]), tuple(d2[1]), d2[2]),
            [G1Wire(*p) for p in ic],
        )
    if device_queries is None:
        device_queries = default_residency(queries["a_query"][1].shape[0])
    qs = {}
    for name in _QUERY_NAMES:
        am, inf = queries[name]
        if _resident(device_queries, name):
            qs[name] = (narrow_to_device(am, dev), narrow_to_device(inf, dev))
        else:
            qs[name] = (narrow_np(am), narrow_np(inf))
    pk = ProvingKey(
        alpha_g1=head["alpha_g1"],
        beta_g1=head["beta_g1"],
        beta_g2=head["beta_g2"],
        delta_g1=head["delta_g1"],
        delta_g2=head["delta_g2"],
        num_inputs=head["num_inputs"],
        **qs,
    )
    return Parameters(pk=pk, vk=vk)


def load_parameters(path: str, device="cuda",
                    device_queries=None) -> Parameters:
    """Load a key saved by `bazuka_tpu.groth16.keygen.save_parameters` or
    `save_parameters` (`*.npz`, or a directory of narrow `.npy` files and
    `head.pkl`), under the residency policy of `params_from_numpy`.  A
    directory's files are memory-mapped: a query left on the host is read
    from disk only when the prover uploads it."""
    if path.endswith(".npz"):
        z = np.load(path, allow_pickle=False)
        head = _load_head(z["head"].tobytes())
        files = {k: z[k] for k in z.files}
        if "b_g2_query_am" not in files:  # pre-round-4 key names
            files["b_g2_query_am"] = files.pop("b_g2_am")
            files["b_g2_query_inf"] = files.pop("b_g2_inf")
    else:
        with open(os.path.join(path, "head.pkl"), "rb") as f:
            head = _load_head(f.read())
        files = {
            name + suf: np.load(os.path.join(path, name + suf + ".npy"),
                                mmap_mode="r")
            for name in _QUERY_NAMES
            for suf in ("_am", "_inf")
        }
    queries = {n: (files[n + "_am"], files[n + "_inf"]) for n in _QUERY_NAMES}
    return params_from_numpy(head, queries, device, device_queries)
