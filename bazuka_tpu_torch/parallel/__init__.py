"""One proof's work split over a mesh of shards (port of
`bazuka_tpu/parallel/__init__.py`).

The JAX package runs one program per chip of a `jax.sharding.Mesh` under
`shard_map`, driven by one process.  The port keeps that single-controller
model: a mesh is a tuple of `torch.device`s, one per shard, and this
process runs each shard's work on its device in turn.  A sharded tensor is
a list of row blocks, block i on shard i; every exchange is explicit
copies between the shards' devices.  Shard i of `make_mesh(n)` is
`cuda:i`; `make_mesh(4, ["cuda:0"])` puts four shards on one card, whose
results must equal the single-device path's, and `make_mesh(8, ["cpu"])`
is the tests' mesh.

  * `all_to_all` — `jax.lax.all_to_all(..., tiled=True)` over the blocks.
  * `ntt_four_step` — the Bailey four-step NTT with three explicit
    all-to-all exchanges; `ntt_sharded` runs it wherever the mesh divides
    both of its factors, else `ntt_mont` on shard 0.
  * `eddsa_verify_sharded` — signature checks, rows split over the shards.
  * `msm_sharded_host` and, in `parallel.prove`, `msm_sharded_v3` and
    `create_proof_sharded`: the v3 drain per shard, the shards' window
    sums tree-reduced with the add-with-select kernels.

The JAX package's `msm_sharded` (its v1 MSM) and `msm_sharded_v2` (the v2
drain) are not ported: the port runs the v3 drain at every size.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..crypto import jubjub as jj
from ..device import resolve_device
from ..fields.host import FR_MODULUS
from ..fields.limbs import fr_field
from ..ops import msm_lm
from ..ops import ntt as ntt_mod
from ..ops.jubjub_batch import batch_eddsa_verify

P = FR_MODULUS

# A mesh: the device of each shard, shard i on mesh[i].
Mesh = Tuple[torch.device, ...]


def make_mesh(n_shards: int, devices: Sequence = None) -> Mesh:
    """A mesh of n_shards shards.  With `devices` None shard i is `cuda:i`,
    and too few cards raise: nothing falls back to the CPU or builds a
    smaller mesh, on which sharded code would pass without proving
    anything.  With `devices` given, the shards go round-robin over them
    (`make_mesh(4, ["cuda:0"])`: four shards on one card)."""
    if n_shards < 1:
        raise ValueError(f"a mesh needs at least one shard, not {n_shards}")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_shards:
            raise RuntimeError(
                f"need {n_shards} CUDA devices, have {have}; pass devices= "
                "to place several shards on one device")
        devices = [f"cuda:{i}" for i in range(n_shards)]
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("no devices given")
    return tuple(devs[i % len(devs)] for i in range(n_shards))


def synchronize(mesh: Mesh) -> None:
    """Wait for every card of the mesh."""
    for dev in dict.fromkeys(d for d in mesh if d.type == "cuda"):
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------- sharded tensors


def shard_rows(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """x split into len(mesh) equal row blocks, block i on mesh[i] (a view
    of x where x already lies there)."""
    D = len(mesh)
    n = x.shape[0]
    if n % D:
        raise ValueError(f"{n} rows do not split over {D} shards")
    m = n // D
    return [x[i * m:(i + 1) * m].to(dev) for i, dev in enumerate(mesh)]


def gather_rows(blocks: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The row blocks of a sharded tensor, concatenated on `device`."""
    return torch.cat([b.to(device) for b in blocks])


def _blocks(x, mesh: Mesh) -> List[torch.Tensor]:
    """A whole tensor split over the mesh, or a sharded one as it is."""
    if isinstance(x, torch.Tensor):
        return shard_rows(x, mesh)
    if len(x) != len(mesh):
        raise ValueError(f"{len(x)} blocks for {len(mesh)} shards")
    return list(x)


def all_to_all(blocks: Sequence[torch.Tensor], mesh: Mesh, split_dim: int,
               concat_dim: int) -> List[torch.Tensor]:
    """`jax.lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)`
    over a sharded tensor: shard i cuts its block into len(mesh) equal
    chunks along split_dim and sends chunk j to shard j, which
    concatenates what it receives along concat_dim in shard order.  A
    shard holds its own block and what it receives, never the whole
    tensor."""
    D = len(mesh)
    if len(blocks) != D:
        raise ValueError(f"{len(blocks)} blocks for {D} shards")
    for b in blocks:
        if b.shape[split_dim] % D:
            raise ValueError(f"dim {split_dim} of {tuple(b.shape)} does not "
                             f"split over {D} shards")
    chunks = [torch.chunk(b, D, dim=split_dim) for b in blocks]
    return [torch.cat([chunks[i][j].to(
        dev, non_blocking=chunks[i][j].is_cuda and dev.type == "cuda")
        for i in range(D)], dim=concat_dim)
        for j, dev in enumerate(mesh)]


# ---------------------------------------------------------------- NTT


def _factors(log_n: int):
    """log2 of the four-step's rows R and columns C: C = 2^(log_n // 2),
    R = N / C (the JAX package's factorization, `parallel/__init__.py:
    ntt_four_step`; the single-card `ops.ntt._ntt_mont_fourstep` factors
    the other way round)."""
    log_c = log_n // 2
    return log_n - log_c, log_c


def _twiddle_block(log_n: int, inverse: bool, shard: int, D: int, device):
    """Shard `shard`'s (R, C/D, 16) block of the four-step's Montgomery
    twiddles T[k1, j2] = w^(j2·k1 mod N), columns j2 in [shard·C/D,
    (shard+1)·C/D), built on `device` from the exponents
    (`ops.ntt._pow_table`)."""
    log_r, log_c = _factors(log_n)
    R, Cd = 1 << log_r, (1 << log_c) // D
    w = ntt_mod.root_of_unity(log_n)
    if inverse:
        w = pow(w, -1, P)
    k1 = torch.arange(R, dtype=torch.int64, device=device)
    j2 = torch.arange(shard * Cd, (shard + 1) * Cd, dtype=torch.int64,
                      device=device)
    e = (k1[:, None] * j2[None, :]) % (1 << log_n)
    return ntt_mod._pow_table(e.reshape(-1), w, log_n).view(R, Cd, -1)


def ntt_four_step(mesh: Mesh, x, inverse: bool = False) -> List[torch.Tensor]:
    """Bailey four-step NTT of (N, 16) Montgomery limbs over the mesh with
    three explicit exchanges; bit-exact against `ops.ntt.ntt_mont`.

    `x` is the whole tensor or its row blocks.  N = R·C; x viewed as the
    (R, C) row-major matrix, row blocks on the shards.  Per shard:
      1. all_to_all -> (R, C/D): whole columns
      2. NTTs of length R down each column (`ntt_mont_batched`, K1's
         stage entry over rows), times the twiddle block w^(j2·k1) (K1)
      3. all_to_all -> (R/D, C), NTTs of length C along each row (and
         times 1/N for the inverse)
      4. all_to_all -> (R, C/D) and a local transpose: the natural-order
         result X[k1 + R·k2] as row blocks of (N/D, 16)
    The mesh must divide both R and C."""
    F = fr_field()
    blocks = _blocks(x, mesh)
    D = len(mesh)
    n = sum(int(b.shape[0]) for b in blocks)
    log_n = ntt_mod._log2(n)
    log_r, log_c = _factors(log_n)
    R, C = 1 << log_r, 1 << log_c
    if R % D or C % D:
        raise ValueError(f"the mesh ({D} shards) must divide both factors "
                         f"of the four-step ({R} x {C})")
    a = [b.reshape(R // D, C, F.n) for b in blocks]
    a = all_to_all(a, mesh, 1, 0)
    a = [ntt_mod.ntt_mont_batched(t.transpose(0, 1).contiguous(), inverse,
                                  scale=False).transpose(0, 1) for t in a]
    a = [F.mont_mul(t, _twiddle_block(log_n, inverse, j, D, t.device))
         for j, t in enumerate(a)]
    a = all_to_all(a, mesh, 0, 1)
    a = [ntt_mod.ntt_mont_batched(t, inverse, scale=False) for t in a]
    if inverse:
        a = [F.mont_mul(t, F.const_mont(pow(n, -1, P), t.device)) for t in a]
    a = all_to_all(a, mesh, 1, 0)
    return [t.transpose(0, 1).reshape(n // D, F.n) for t in a]


def ntt_sharded(mesh: Mesh, x, inverse: bool = False) -> List[torch.Tensor]:
    """NTT of (N, 16) Montgomery limbs (whole or row blocks) over the mesh,
    as row blocks.  The JAX package runs its radix-2 stage loop over a
    sharded input and lets XLA insert the exchanges; the port runs the
    four-step (`ntt_four_step`) wherever the mesh divides both of its
    factors, and below that `ntt_mont` on shard 0, re-sharded: the
    fallback of `compute_h_sharded`."""
    blocks = _blocks(x, mesh)
    n = sum(int(b.shape[0]) for b in blocks)
    if _mesh_fits_fourstep(n, len(mesh)):
        return ntt_four_step(mesh, blocks, inverse)
    return shard_rows(ntt_mod.ntt_mont(gather_rows(blocks, mesh[0]), inverse),
                      mesh)


# ---------------------------------------------------------------- EdDSA


def eddsa_verify_sharded(mesh: Mesh, pks, msgs, sigs) -> np.ndarray:
    """`ops.jubjub_batch.batch_eddsa_verify` with the rows split over the
    mesh (the reference's rayon par_iter, src/mpn/update.rs:31-38): padded
    to a multiple of the shards with a valid signature under the key of
    seed b"pad", each shard's rows verified on its device; the pad rows
    dropped.  Returns a (B,) numpy bool array."""
    D = len(mesh)
    n = len(pks)
    pad = (-n) % D
    pk0, sk0 = jj.JubJub.generate_keys(b"pad")
    sig0 = jj.JubJub.sign(sk0, 0)
    pks = list(pks) + [pk0.decompress()] * pad
    msgs = list(msgs) + [0] * pad
    sigs = list(sigs) + [sig0] * pad
    m = len(pks) // D
    ok = [batch_eddsa_verify(pks[i * m:(i + 1) * m], msgs[i * m:(i + 1) * m],
                             sigs[i * m:(i + 1) * m], device=dev)
          for i, dev in enumerate(mesh)]
    return np.concatenate(ok)[:n]


# ---------------------------------------------------------------- MSM


def msm_sharded_host(mesh: Mesh, points, scalars, kind: str = "g1",
                     c: int = None, nbits: int = 255):
    """Host affine points and int scalars -> the host affine sum, over
    `msm_sharded_v3`: padded with infinity rows to a power of two (at
    least 16) that the mesh divides."""
    from ..groth16.prove import _msm_c

    D = len(mesh)
    n = 16
    while n < len(points) or n % D:
        n *= 2
    points = list(points) + [None] * (n - len(points))
    scalars = list(scalars) + [0] * (n - len(scalars))
    to_am = msm_lm.points_to_am if kind == "g1" else msm_lm.points_to_am_g2
    query = to_am(points, device=mesh[0])
    s = msm_lm.enc_scalars(scalars, device=mesh[0])
    return msm_sharded_v3(mesh, query, s, kind, c=c or _msm_c(n // D),
                          nbits=nbits)


# ---------------------------------------------------- the sharded prover
# (at the bottom: parallel.prove imports ntt_four_step from this module)

from .prove import (  # noqa: E402
    _mesh_fits_fourstep,
    compute_h_sharded,
    coset_intt_fs,
    coset_ntt_fs,
    create_proof_sharded,
    msm_sharded_v3,
)
