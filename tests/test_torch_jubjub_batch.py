"""The port's batched JubJub arithmetic and EdDSA verification
(`bazuka_tpu_torch/ops/jubjub_batch.py`) against the JAX package's
(`bazuka_tpu/ops/jubjub_batch.py`, `backend="np"`), on the CPU, with exact
equality: extended coordinates limb for limb, affine points and verdicts
against the host curve.

- The fixed-base table 2^i·B (i = 0..254) equals the JAX package's, limb
  for limb.
- `ext_add` on random points and on its edge cases (P + P, P + (−P),
  P + 0, 0 + 0).
- `batch_base_mul` and `batch_scalar_mul` on scalars that include 0, 1 and
  ORDER.
- `batch_eddsa_verify` on four signatures, one tampered, against both
  `backend="np"` and `backend="jax"` (JAX on the CPU, about 25 s of
  compiling); its Fr products by kind (multiply, squaring, reduction)
  per signature are those of `chip_smoke.EDDSA_PRODUCTS` (the bound of
  the `eddsa` phase) with the doublings counted as the code runs them.
"""

import math

import numpy as np
import torch

import chip_smoke
from bazuka_tpu.fields.limbs import fr_field as jax_fr_field
from bazuka_tpu.ops import jubjub_batch as jjb
from bazuka_tpu_torch.crypto import jubjub as tjj
from bazuka_tpu_torch.fields.limbs import fr_field, to_numpy, to_torch
from bazuka_tpu_torch.ops import field_kernel as fk
from bazuka_tpu_torch.ops import jubjub_batch as tjb

# The shapes here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

F = fr_field()
JF = jax_fr_field("np")


def _enc(vals, mont=True):
    """Python ints -> (the JAX package's uint32 limbs, the port's int32
    CPU tensor), the same bits."""
    a = np.asarray(JF.encode(np.array(vals, dtype=object), mont=mont))
    return a, to_torch(a, "cpu")


def _points(pts):
    """Affine points -> (the port's extended point, the JAX package's)."""
    jx, tx = _enc([p[0] for p in pts])
    jy, ty = _enc([p[1] for p in pts])
    return tjb.to_extended(F, tx, ty), jjb.to_extended(JF, jx, jy)


def _same(got, want) -> bool:
    return all(np.array_equal(to_numpy(g), np.asarray(w))
               for g, w in zip(got, want))


def test_base_powers_equal_jax():
    for got, want in zip(tjb._base_powers_np(), jjb._base_powers_np()):
        assert got.dtype == np.uint32 and got.shape == (255, 16)
        assert np.array_equal(got, np.asarray(want))


def test_ext_add_random_points():
    rng = np.random.default_rng(1)
    pts = [tjj.point_mul(tjj.BASE, int(k))
           for k in rng.integers(1, 2**62, size=6)]
    tP, jP = _points(pts[:3])
    tQ, jQ = _points(pts[3:])
    got = tjb.ext_add(F, tP, tQ)
    assert _same(got, jjb.ext_add(JF, jP, jQ))
    assert list(tjb.to_affine_host(F, got)) == [
        tjj.point_add(pts[i], pts[3 + i]) for i in range(3)]


def test_ext_add_edge_cases():
    g = tjj.BASE
    neg_g = tjj.point_neg(g)
    # P + P (doubling), P + (−P) (identity), P + 0, 0 + 0
    tP, jP = _points([g, g, g, tjj.ZERO])
    tQ, jQ = _points([g, neg_g, tjj.ZERO, tjj.ZERO])
    got = tjb.ext_add(F, tP, tQ)
    assert _same(got, jjb.ext_add(JF, jP, jQ))
    assert list(tjb.to_affine_host(F, got)) == [
        tjj.point_double(g), tjj.ZERO, g, tjj.ZERO]


SCALARS = [3 ** 100 + 12345, 2 ** 254 + 7, 0, 1, tjj.ORDER]


def test_batch_base_mul():
    js, ts = _enc(SCALARS, mont=False)
    got = tjb.batch_base_mul(F, ts)
    assert _same(got, jjb.batch_base_mul(JF, js))
    assert list(tjb.to_affine_host(F, got)) == [
        tjj.point_mul(tjj.BASE, s) for s in SCALARS]


def test_batch_scalar_mul():
    js, ts = _enc(SCALARS, mont=False)
    base7 = tjj.point_mul(tjj.BASE, 7)
    tP, jP = _points([base7] * len(SCALARS))
    got = tjb.batch_scalar_mul(F, tP, ts)
    assert _same(got, jjb.batch_scalar_mul(JF, jP, js))
    assert list(tjb.to_affine_host(F, got)) == [
        tjj.point_mul(base7, s) for s in SCALARS]


def _signed(n: int = 4):
    """n keys and signatures (seeds 0..n-1, messages 1000 + i), the last
    message tampered with."""
    pks, msgs, sigs = [], [], []
    for i in range(n):
        pk, sk = tjj.JubJub.generate_keys(bytes([i]))
        pks.append(pk.decompress())
        msgs.append(1000 + i)
        sigs.append(tjj.JubJub.sign(sk, 1000 + i))
    msgs[-1] = 9999
    return pks, msgs, sigs


def test_batch_eddsa_verify(monkeypatch):
    pks, msgs, sigs = _signed()
    products = []
    plain = fk.mont_mul_plain

    def counting(F_, a, b):
        kind = ("sqr" if a is b else
                "redc" if b is F_._const("one", b.device) else "mul")
        products.append((kind, math.prod(
            torch.broadcast_shapes(a.shape, b.shape)[:-1])))
        return plain(F_, a, b)

    monkeypatch.setattr(fk, "mont_mul_plain", counting)
    got = tjb.batch_eddsa_verify(pks, msgs, sigs, device="cpu")
    monkeypatch.undo()
    assert got.dtype == np.bool_
    assert list(got) == [True, True, True, False]
    for backend in ("np", "jax"):
        want = jjb.batch_eddsa_verify(pks, msgs, sigs, backend)
        assert list(got) == list(want), backend
    counted = {kind: sum(n for k, n in products if k == kind) // len(pks)
               for kind in ("mul", "sqr", "redc")}
    assert counted == {"mul": 9345, "sqr": 210, "redc": 1}
    # the bound counts the code's 255 doublings, each a complete add of
    # nine multiplies, at a doubling's four multiplies and four squarings
    assert chip_smoke.EDDSA_PRODUCTS == {
        "mul": counted["mul"] - 255 * 9 + 255 * 4,
        "sqr": counted["sqr"] + 255 * 4, "redc": 1}
