"""The port's batched Poseidon (`bazuka_tpu_torch/ops/poseidon.py`) against
the JAX package's (`bazuka_tpu/ops/poseidon.py`), on the CPU, with exact
equality.

- The Montgomery round-constant and MDS tables of every width t = 2..17
  equal the JAX package's, limb for limb.
- The reference's golden vectors at arities 1, 4, 5 and 16 (all 16 in the
  slow tier), as the JAX package's tests split them.
- Random inputs at arities 2, 4, 5 and 7 hash to the JAX package's limbs
  (`backend="np"`); at arity 4 `poseidon_batch` also equals
  `backend="jax"` (JAX on the CPU) and the host Poseidon.
- `chip_smoke.py` pins the reference's golden vectors, and its count of Fr
  products per hash by kind (the bound of the `poseidon` phase) is what
  the code takes: multiplies, and squarings (a product of a tensor with
  itself).
"""

import math
import random

import numpy as np
import pytest
import torch

from test_poseidon import GOLDEN

import chip_smoke
from bazuka_tpu.fields.host import FR_MODULUS
from bazuka_tpu.fields.limbs import fr_field as jax_fr_field
from bazuka_tpu.ops import poseidon as jp
from bazuka_tpu.zk.poseidon_host import poseidon as jax_host_poseidon
from bazuka_tpu_torch.fields.limbs import fr_field, to_numpy, to_torch
from bazuka_tpu_torch.ops import field_kernel as fk
from bazuka_tpu_torch.ops import poseidon as tp

# The shapes here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)


@pytest.mark.parametrize("t", range(2, 18))
def test_mont_params_equal_jax(t):
    p, rc, mds = tp._mont_params(t)
    jpar, jrc, jmds = jp._mont_params(t)
    assert (p.full_rounds, p.partial_rounds) == (jpar.full_rounds,
                                                 jpar.partial_rounds)
    assert rc.dtype == mds.dtype == np.uint32
    assert np.array_equal(rc, jrc)
    assert np.array_equal(mds, jmds)


def _golden(arity: int) -> int:
    got = tp.poseidon_batch(np.array([list(range(arity))], dtype=object),
                            device="cpu")
    return int(got[0])


@pytest.mark.parametrize("arity", [1, 4, 5, 16])
def test_golden_vectors(arity):
    assert _golden(arity) == int(GOLDEN[arity - 1])


@pytest.mark.slow
def test_golden_vectors_all_arities():
    for arity in range(1, len(GOLDEN) + 1):
        assert _golden(arity) == int(GOLDEN[arity - 1]), f"arity {arity}"


@pytest.mark.parametrize("arity", [2, 4, 5, 7])
def test_random_inputs_equal_jax_np(arity):
    rng = random.Random(arity)
    vals = np.array([[rng.randrange(FR_MODULUS) for _ in range(arity)]
                     for _ in range(5)], dtype=object)
    enc = np.asarray(jax_fr_field("np").encode(vals))  # (5, arity, 16)
    want = jp.poseidon_batch_mont(enc, backend="np")
    got = tp.poseidon_batch_mont(to_torch(enc, "cpu"))
    assert np.array_equal(to_numpy(got), np.asarray(want))


def test_poseidon_batch_equals_jax_backend_and_host():
    rng = random.Random(99)
    vals = np.array([[rng.randrange(FR_MODULUS) for _ in range(4)]
                     for _ in range(8)], dtype=object)
    got = [int(v) for v in tp.poseidon_batch(vals, device="cpu")]
    assert got == [int(v) for v in jp.poseidon_batch(vals, backend="jax")]
    assert got == [jax_host_poseidon(list(row)) for row in vals]


def test_chip_smoke_pins_golden_vectors_and_counts_multiplies():
    assert chip_smoke.POSEIDON_GOLDEN == tuple(int(g) for g in GOLDEN)
    F = fr_field()
    products = []

    def counting(a, b):
        products.append(("sqr" if a is b else "mul", math.prod(
            torch.broadcast_shapes(a.shape, b.shape)[:-1])))
        return fk.mont_mul_plain(F, a, b)

    B = 3
    x = torch.zeros(B, 4, F.n, dtype=torch.int32)
    assert torch.equal(tp.poseidon_batch_mont(x, mul=counting),
                       tp.poseidon_batch_mont(x))
    counted = {kind: sum(n for k, n in products if k == kind)
               for kind in ("mul", "sqr")}
    want = chip_smoke.poseidon_products(5)
    assert counted == {k: B * want[k] for k in ("mul", "sqr")}
    assert want == {"mul": 1696, "sqr": 192, "redc": 0}
