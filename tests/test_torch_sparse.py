"""Port parity: sparse R1CS row evaluation (`bazuka_tpu_torch.groth16.sparse`)
against `bazuka_tpu.groth16.sparse.DeviceR1CS(..., "np")`, limb for limb,
on the toy multiply circuit and on a random sparse circuit whose A matrix
holds ONE in every row and one row denser than the JAX package's level-1
segment bound (2^15 terms)."""

import numpy as np
import pytest
import torch

from bazuka_tpu.fields.host import FR_MODULUS
from bazuka_tpu.groth16 import sparse as js
from bazuka_tpu.groth16.r1cs import ONE as J_ONE
from bazuka_tpu.groth16.r1cs import ConstraintSystem as JCS
from bazuka_tpu.groth16.r1cs import lc as j_lc
from bazuka_tpu_torch.fields.limbs import fr_field, to_numpy
from bazuka_tpu_torch.groth16 import sparse as ts

# The shapes here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

P = FR_MODULUS


def toy_circuit():
    cs = JCS()
    z = cs.alloc_input(15)
    x, y = cs.alloc(3), cs.alloc(5)
    cs.enforce(j_lc((x, 1)), j_lc((y, 1)), j_lc((z, 1)))
    s = cs.alloc(8)
    cs.enforce(j_lc((x, 1), (y, 1)), j_lc((J_ONE, 1)), j_lc((s, 1)))
    return cs


def random_circuit(seed, n_vars=40, n_cons=50, dense_row=3 << 14):
    rng = np.random.default_rng(seed)
    cs = JCS()
    ins = [cs.alloc_input(int(rng.integers(0, 2**62))) for _ in range(3)]
    aux = [cs.alloc(int.from_bytes(rng.bytes(32), "little") % P)
           for _ in range(n_vars)]
    vars_ = ins + aux
    coeffs = [1, P - 1, 2, 7, int(rng.integers(0, 2**62))]

    def rand_lc(k, with_one):
        terms = {int(v): coeffs[int(rng.integers(0, len(coeffs)))]
                 for v in rng.choice(vars_, size=k, replace=False)}
        if with_one:
            terms[J_ONE] = coeffs[int(rng.integers(0, len(coeffs)))]
        return j_lc(*terms.items())

    for _ in range(n_cons):
        cs.enforce(rand_lc(int(rng.integers(1, 5)), True),
                   rand_lc(int(rng.integers(0, 4)), False),
                   rand_lc(int(rng.integers(0, 3)), False))
    if dense_row:
        many = [cs.alloc(int(v)) for v in rng.integers(0, 2**62, dense_row)]
        cs.enforce(j_lc((J_ONE, 3), *((v, 1) for v in many)),
                   j_lc((J_ONE, 1)), j_lc())
    return cs


@pytest.mark.parametrize("name", ["toy", "random"])
def test_row_evals_match_jax(name):
    cs = toy_circuit() if name == "toy" else random_circuit(7)
    comp = cs.compiled()
    z = cs.full_assignment()
    want = js.DeviceR1CS(comp, "np").eval_rows(js.encode_mont(z, "np"))
    got = ts.DeviceR1CS(comp, "cpu").eval_rows(ts.encode_mont(z, "cpu"))
    for g, w in zip(got, want):
        assert np.array_equal(to_numpy(g), np.asarray(w, np.uint32))
    # and against the matrices evaluated with Python ints
    for m, g in enumerate(got):
        acc = [0] * (comp.n_constraints + comp.num_inputs)
        for r, v, c in zip(comp.rows[m], comp.vars[m], comp.cids[m]):
            acc[r] += z[v] * comp.palette[c]
        if m == 0:  # bellman's extension rows input_i * 0 = 0
            for i in range(comp.num_inputs):
                acc[comp.n_constraints + i] += z[i]
        assert [int(v) for v in fr_field().decode(g)] == [a % P for a in acc]
    assert np.array_equal(to_numpy(ts.encode_mont(z, "cpu")),
                          np.asarray(js.encode_mont(z, "np"), np.uint32))


def test_redundant_reduce_folds_wide_sums():
    """Limb sums up to 2^47 fold back to the canonical residue."""
    F = fr_field()
    rng = np.random.default_rng(3)
    s = torch.from_numpy(rng.integers(0, 1 << 47, size=(16, 16)))
    got = [int(v) for v in F.decode(ts.redundant_reduce(s), mont=False)]
    want = [sum(int(l) << (16 * k) for k, l in enumerate(row)) % P
            for row in s.tolist()]
    assert got == want
