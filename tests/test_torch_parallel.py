"""The port's sharded prover (`bazuka_tpu_torch/parallel/`) against the JAX
package's (`bazuka_tpu/parallel/`) and the single-device port, on meshes of
`["cpu"]` shards.

- `make_mesh` raises for CUDA without a card and never builds a smaller
  mesh.
- `all_to_all` equals `jax.lax.all_to_all(tiled=True)` under `shard_map` on
  the conftest's 8-device CPU mesh, at D = 2, 4 and 8, for both (split,
  concat) pairs the four-step uses.
- The per-shard twiddle blocks, side by side, equal the JAX package's
  `_four_step_consts` matrix.
- `ntt_four_step` equals `ntt_host` and the port's `ntt_mont` at 2^10 and
  2^11 over 2, 4 and 8 shards, both directions, in 3 exchanges in which
  each shard receives n / D elements; `ntt_sharded` passes the JAX test's
  64 values at D = 8.
- `compute_h_sharded` equals `compute_h_mont` on the four-step and on its
  fallback.
- `msm_sharded_v3` against host sums: G1 over 3 and 4 shards (the odd
  tree level's carry), infinity rows with nonzero scalars, G2, and the
  dedup split with the query on the host and as tensors;
  `msm_sharded_host` on the JAX test's 16 points over 8 shards.
- `eddsa_verify_sharded` on the JAX test's five signatures over 2 shards.
- `create_proof_sharded` on the committed toy key over 2 shards (d = 4:
  the four-step runs in the proof) gives the JAX package's pinned bytes,
  verifies and rejects; a mesh that does not divide Np raises.
- Slow tier: the JAX test's chain circuit over 8 shards, the port's proof
  under a port key of seed b"sharded" byte-equal to the JAX package's
  `create_proof_sharded` under the JAX key of the same seed.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from bazuka_tpu.ops import ntt as jn
from bazuka_tpu.parallel import _four_step_consts
from bazuka_tpu_torch import parallel as par
from bazuka_tpu_torch.crypto import bls12_381 as bls
from bazuka_tpu_torch.crypto import jubjub as tjj
from bazuka_tpu_torch.fields.host import FR_MODULUS
from bazuka_tpu_torch.fields.limbs import fr_field, to_numpy
from bazuka_tpu_torch.groth16 import keygen, prove
from bazuka_tpu_torch.groth16.verify import groth16_verify
from bazuka_tpu_torch.ops import msm_lm
from bazuka_tpu_torch.ops import ntt as tn
from bazuka_tpu_torch.ops.jubjub_batch import batch_eddsa_verify
from bazuka_tpu_torch.parallel import prove as pprove
from bazuka_tpu_torch.utils import ser

# The shapes here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

P = FR_MODULUS
F = fr_field()


def rand_vals(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


def cpu_mesh(D):
    return par.make_mesh(D, ["cpu"])


def test_make_mesh_never_falls_back():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError):
        par.make_mesh(2)
    with pytest.raises(RuntimeError):
        par.make_mesh(4, ["cuda:0"])
    mesh = par.make_mesh(8, ["cpu"])
    assert mesh == (torch.device("cpu"),) * 8
    assert par.make_mesh(3, ["cpu", "cpu"]) == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError):
        par.make_mesh(0, ["cpu"])


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("split,concat", [(1, 0), (0, 1)])
def test_all_to_all_equals_jax(D, split, concat):
    import jax
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS

    rng = np.random.default_rng(D + 10 * split)
    x = rng.integers(0, 1 << 31, size=(D * 2 * D, 4 * D, 3), dtype=np.int32)
    jmesh = Mesh(np.array(jax.devices()[:D]), ("x",))
    fn = shard_map(
        lambda b: jax.lax.all_to_all(b, "x", split, concat, tiled=True),
        mesh=jmesh, in_specs=PS("x"), out_specs=PS("x"), check_rep=False)
    want = np.asarray(jax.jit(fn)(
        jax.device_put(x, NamedSharding(jmesh, PS("x")))))
    got = par.all_to_all(par.shard_rows(torch.from_numpy(x), cpu_mesh(D)),
                         cpu_mesh(D), split, concat)
    assert np.array_equal(torch.cat(got).numpy(), want)


@pytest.mark.parametrize("log_n", [8, 9])
@pytest.mark.parametrize("inverse", [False, True])
def test_twiddle_blocks_equal_jax(log_n, inverse):
    want = np.asarray(_four_step_consts(log_n, inverse, "np")[0])
    for D in (2, 4):
        blocks = [par._twiddle_block(log_n, inverse, j, D, "cpu")
                  for j in range(D)]
        assert np.array_equal(to_numpy(torch.cat(blocks, dim=1)), want)


@pytest.mark.parametrize("log_n", [10, 11])
@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_four_step_exact_in_three_exchanges(log_n, D, inverse,
                                                monkeypatch):
    n = 1 << log_n
    vals = rand_vals(n, log_n + 10 * D + inverse)
    x = F.encode(vals, device="cpu")
    received = []
    real = par.all_to_all

    def spy(blocks, mesh, split_dim, concat_dim):
        out = real(blocks, mesh, split_dim, concat_dim)
        received.append([b.numel() // F.n for b in out])
        return out

    monkeypatch.setattr(par, "all_to_all", spy)
    blocks = par.ntt_four_step(cpu_mesh(D), x, inverse)
    assert len(received) == 3
    assert received == [[n // D] * D] * 3
    assert all(b.shape == (n // D, F.n) for b in blocks)
    got = torch.cat(blocks)
    assert [int(v) for v in F.decode(got)] == jn.ntt_host(vals, inverse)
    assert torch.equal(got, tn.ntt_mont(x, inverse))


def test_ntt_sharded_matches_host():
    rng = np.random.default_rng(1)
    vals = [int(v) for v in rng.integers(0, 2**63, size=64)]
    out = par.ntt_sharded(cpu_mesh(8), F.encode(vals, device="cpu"))
    assert [int(v) for v in F.decode(torch.cat(out))] == jn.ntt_host(vals)


@pytest.mark.parametrize("d,D", [(64, 4), (64, 8), (16, 8)])
def test_compute_h_sharded_equals_single(d, D):
    assert pprove._mesh_fits_fourstep(d, D) == (d == 64)
    evs = [F.encode(rand_vals(d, 50 + k), device="cpu") for k in range(3)]
    want = prove.compute_h_mont([e.clone() for e in evs], d)
    got = pprove.compute_h_sharded(cpu_mesh(D), list(evs), d)
    assert got.shape == (d - 1, F.n)
    assert torch.equal(got, want)


# ------------------------------------------------------------------- MSM


def _query(kind, ks, none_rows=()):
    """Points k·G for the multipliers ks (None at none_rows), as the
    port's (affine limbs, inf flags) on the CPU, and the host points."""
    gen, mul = ((bls.G1_GEN, bls.g1_mul) if kind == "g1"
                else (bls.G2_GEN, bls.g2_mul))
    table = {}
    pts = []
    for i, k in enumerate(ks):
        if i in none_rows:
            pts.append(None)
            continue
        if k not in table:
            table[k] = mul(gen, int(k))
        pts.append(table[k])
    to_am = msm_lm.points_to_am if kind == "g1" else msm_lm.points_to_am_g2
    return to_am(pts, device="cpu"), pts


def _oracle(kind, ks, scalars, none_rows=()):
    total = sum(int(k) * s for i, (k, s) in enumerate(zip(ks, scalars))
                if i not in none_rows) % bls.R
    return (bls.g1_mul(bls.G1_GEN, total) if kind == "g1"
            else bls.g2_mul(bls.G2_GEN, total))


@pytest.mark.parametrize("D,n", [(3, 96), (4, 128)])
def test_msm_sharded_v3_g1_matches_oracle(D, n):
    rng = np.random.default_rng(D)
    nbits = 16
    ks = (np.arange(n) % 32) + 1
    none_rows = {5, n - 1}  # infinity rows with nonzero scalars
    scalars = [int(s) for s in rng.integers(1, 1 << nbits, size=n)]
    query, _ = _query("g1", ks, none_rows)
    got = par.msm_sharded_v3(cpu_mesh(D), query,
                             msm_lm.enc_scalars(scalars, "cpu"), c=4,
                             nbits=nbits)
    assert got == _oracle("g1", ks, scalars, none_rows)
    with pytest.raises(ValueError):
        par.msm_sharded_v3(cpu_mesh(5), query,
                           msm_lm.enc_scalars(scalars, "cpu"), c=4,
                           nbits=nbits)


def test_msm_sharded_v3_g2_matches_oracle():
    rng = np.random.default_rng(7)
    n, nbits = 32, 16
    ks = (np.arange(n) % 8) + 1
    scalars = [int(s) for s in rng.integers(1, 1 << nbits, size=n)]
    query, _ = _query("g2", ks)
    got = par.msm_sharded_v3(cpu_mesh(2), query,
                             msm_lm.enc_scalars(scalars, "cpu"), kind="g2",
                             c=4, nbits=nbits)
    assert got == _oracle("g2", ks, scalars)


@pytest.mark.parametrize("on_host", [True, False])
def test_msm_sharded_v3_dedup_split(on_host):
    n, nbits = 128, 16
    ks = (np.arange(n) % 32) + 1
    scalars = [1 if i % 3 else 7 for i in range(n)]
    s_std = msm_lm.enc_scalars(scalars, "cpu")
    plan = msm_lm.make_dedup_plan(to_numpy(s_std), threshold=8)
    assert plan.active
    (am, inf), _ = _query("g1", ks)
    query = ((to_numpy(am), inf.numpy().astype(np.uint8)) if on_host
             else (am, inf))
    got = par.msm_sharded_v3(cpu_mesh(4), query, s_std, c=4, nbits=nbits,
                             dedup_plan=plan)
    assert got == _oracle("g1", ks, scalars)


def test_msm_sharded_host_matches_naive():
    rng = np.random.default_rng(0)
    n = 16
    pts = [bls.g1_mul(bls.G1_GEN, int(k))
           for k in rng.integers(1, 2**30, size=n)]
    scalars = [int(s) for s in rng.integers(0, 2**62, size=n)]
    want = None
    for p, s in zip(pts, scalars):
        want = bls.g1_add(want, bls.g1_mul(p, s))
    assert par.msm_sharded_host(cpu_mesh(8), pts, scalars, c=4,
                                nbits=64) == want


def test_eddsa_verify_sharded():
    pks, msgs, sigs = [], [], []
    for i in range(5):
        pk, sk = tjj.JubJub.generate_keys(bytes([i]))
        sigs.append(tjj.JubJub.sign(sk, 777 + i))
        pks.append(pk.decompress())
        msgs.append(777 + i)
    msgs[2] = 999  # tamper one
    ok = par.eddsa_verify_sharded(cpu_mesh(2), pks, msgs, sigs)
    assert list(ok) == [True, True, False, True, True]
    assert np.array_equal(ok, batch_eddsa_verify(pks, msgs, sigs,
                                                 device="cpu"))


# -------------------------------------------------------------- the prover


def test_toy_sharded_proof_equals_jax_bytes():
    params = keygen.load_parameters(chip_smoke.TOY_KEY, device="cpu")
    cs, z = chip_smoke.toy_circuit()
    with pytest.raises(ValueError):
        par.create_proof_sharded(params, cs, cpu_mesh(3), r=7, s=11)
    record = {}
    proof = par.create_proof_sharded(params, cs, cpu_mesh(2), r=7, s=11,
                                     record=record)
    assert pprove._mesh_fits_fourstep(4, 2)
    assert ser.dumps(proof).hex() == chip_smoke.TOY_PROOF_HEX
    single = prove.create_proof(params, cs, r=7, s=11, device="cpu")
    assert ser.dumps(single) == ser.dumps(proof)
    assert groth16_verify(params.vk, [z], proof)
    assert not groth16_verify(params.vk, [(z + 1) % P], proof)
    assert set(record["seconds"]) >= {"row_eval", "h_ntt", "msm_a",
                                      "msm_b_g2", "combine"}


def chain_circuit(r1cs, x0=3, n_sq=40, n_dup=14):
    """`tests/test_sharded_prove.py`'s circuit over either package's
    `groth16.r1cs`: a squaring chain and duplicate wires of value 1, d =
    64 (the smallest domain the 8-way four-step factorization takes) and
    enough duplicates for the dedup split to run in the proof."""
    cs = r1cs.ConstraintSystem(proving=True)
    cur = x0 % P
    x = cs.alloc(cur)
    for _ in range(n_sq):
        cur = cur * cur % P
        v = cs.alloc(cur)
        cs.enforce(r1cs.lc((x, 1)), r1cs.lc((x, 1)), r1cs.lc((v, 1)))
        x = v
    z = cs.alloc_input(cur)
    cs.enforce(r1cs.lc((x, 1)), r1cs.lc((r1cs.ONE, 1)), r1cs.lc((z, 1)))
    for _ in range(n_dup):
        v = cs.alloc(1)
        cs.enforce(r1cs.lc((v, 1)), r1cs.lc((r1cs.ONE, 1)),
                   r1cs.lc((r1cs.ONE, 1)))
    return cs, cur


@pytest.mark.slow
def test_chain_circuit_sharded_proof_equals_jax():
    from bazuka_tpu.groth16 import r1cs as j_r1cs
    from bazuka_tpu.groth16.keygen import generate_parameters as j_keygen
    from bazuka_tpu.parallel import create_proof_sharded as j_sharded
    from bazuka_tpu.parallel import make_mesh as j_mesh
    from bazuka_tpu.utils import ser as j_ser

    from bazuka_tpu_torch.groth16 import r1cs

    j_cs, _ = chain_circuit(j_r1cs)
    want = j_sharded(j_keygen(j_cs, seed=b"sharded"), j_cs, j_mesh(8),
                     r=7, s=11)
    j_bytes = j_ser.Writer()
    want.write_to(j_bytes)
    cs, z = chain_circuit(r1cs)
    params = keygen.generate_parameters(cs, seed=b"sharded", device="cpu")
    got = par.create_proof_sharded(params, cs, cpu_mesh(8), r=7, s=11)
    assert ser.dumps(got) == j_bytes.getvalue()
    assert groth16_verify(params.vk, [z], got)
    assert not groth16_verify(params.vk, [(z + 1) % P], got)
