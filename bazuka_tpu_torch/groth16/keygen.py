"""Groth16 parameter types and loading (port of the host side of
`bazuka_tpu/groth16/keygen.py`; parameter generation on the card is a later
slice).

Query tensors live on the device: G1 queries as ((Np, 2, 24) int32 affine
Montgomery limbs, (Np,) bool infinity mask), the G2 query as ((Np, 4, 24),
(Np,)).  Singleton points are host affine tuples.

Keys written by `bazuka_tpu` load unchanged: both layouts (one `.npz`, or a
directory of `.npy` files with `head.pkl`) pickle their header with the JAX
package's class names, so the header is read by an unpickler that maps
those three names to this package's copies and refuses any other class.
"""

from __future__ import annotations

import io
import os
import pickle
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..crypto import bls12_381 as bls
from ..device import resolve_device
from ..zk.proof import G1Wire, G2Wire, Groth16VerifyingKey
from .sparse import DeviceR1CS

_QUERY_NAMES = ("a_query", "b_g1_query", "l_query", "h_query", "b_g2_query")


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


def _query_to_device(am, inf, device):
    """uint16/uint32 affine limbs + 0/1 flags -> (int32 limbs, bool mask)."""
    am = torch.from_numpy(
        np.ascontiguousarray(np.asarray(am).astype(np.int32))).to(device)
    inf = torch.from_numpy(np.asarray(inf) != 0).to(device)
    return am, inf


def params_from_numpy(head: dict, queries: dict, device="cuda") -> Parameters:
    """Parameters from host data: `head` holds the singleton points
    (alpha_g1, beta_g1, beta_g2, delta_g1, delta_g2), `num_inputs`, and
    `vk` as wire tuples (the fields of Groth16VerifyingKey in order, each
    point as (x, y, infinity)); `queries` maps each query name to its
    (am, inf) numpy pair, limbs uint16 or uint32."""
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
    qs = {name: _query_to_device(*queries[name], dev) for name in _QUERY_NAMES}
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


def load_parameters(path: str, device="cuda") -> Parameters:
    """Load a key saved by `bazuka_tpu.groth16.keygen.save_parameters`
    (`*.npz`, or a directory of narrow `.npy` files and `head.pkl`)."""
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
    return params_from_numpy(head, queries, device)
