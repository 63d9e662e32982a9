"""The port's prover as a whole (`bazuka_tpu_torch.groth16`) against the JAX
package: the same proof bytes on the committed toy key at pinned r, s; the
verifier accepting and rejecting as tests/test_groth16.py:69-95; and keys
loaded by the port, from both on-disk layouts and from numpy, equal."""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

import chip_smoke
from bazuka_tpu.groth16 import keygen as jk
from bazuka_tpu.groth16 import r1cs as jr
from bazuka_tpu.groth16.prove import create_proof as j_create_proof
from bazuka_tpu.utils import ser as jser
from bazuka_tpu_torch.fields.host import FR_MODULUS
from bazuka_tpu_torch.fields.limbs import to_numpy
from bazuka_tpu_torch.groth16 import keygen as tk
from bazuka_tpu_torch.groth16 import prove as tprove
from bazuka_tpu_torch.groth16.prove import create_proof
from bazuka_tpu_torch.groth16.r1cs import ONE, ConstraintSystem, lc
from bazuka_tpu_torch.groth16.verify import groth16_verify
from bazuka_tpu_torch.utils import ser
from bazuka_tpu_torch.zk.proof import G1Wire

# The shapes here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

P = FR_MODULUS
PINNED = os.path.join(os.path.dirname(__file__), "data",
                      "toy_multiply_params.npz")
QUERIES = ("a_query", "b_g1_query", "l_query", "h_query", "b_g2_query")


def multiply_circuit(x, y, z=None):
    cs = ConstraintSystem(proving=True)
    z = x * y % P if z is None else z
    z_var = cs.alloc_input(z)
    x_var, y_var = cs.alloc(x), cs.alloc(y)
    cs.enforce(lc((x_var, 1)), lc((y_var, 1)), lc((z_var, 1)))
    s_var = cs.alloc((x + y) % P)
    cs.enforce(lc((x_var, 1), (y_var, 1)), lc((ONE, 1)), lc((s_var, 1)))
    return cs, z


@pytest.fixture(scope="module")
def params():
    return tk.load_parameters(PINNED, device="cpu")


def test_proof_equals_jax_and_pinned_bytes(params):
    cs, z = multiply_circuit(3, 5)
    proof = create_proof(params, cs, r=7, s=11, device="cpu")
    j_cs = jr.ConstraintSystem(proving=True)
    zv, xv, yv = j_cs.alloc_input(z), j_cs.alloc(3), j_cs.alloc(5)
    j_cs.enforce(jr.lc((xv, 1)), jr.lc((yv, 1)), jr.lc((zv, 1)))
    sv = j_cs.alloc(8)
    j_cs.enforce(jr.lc((xv, 1), (yv, 1)), jr.lc((jr.ONE, 1)),
                 jr.lc((sv, 1)))
    j_proof = j_create_proof(jk.load_parameters(PINNED), j_cs, r=7, s=11)
    j_bytes = jser.Writer()
    j_proof.write_to(j_bytes)
    assert ser.dumps(proof) == j_bytes.getvalue()
    assert j_bytes.getvalue().hex() == chip_smoke.TOY_PROOF_HEX


def test_verify_accepts_and_rejects(params):
    cs, z = multiply_circuit(3, 5)
    proof = create_proof(params, cs, r=7, s=11, device="cpu")
    assert groth16_verify(params.vk, [z], proof)
    assert not groth16_verify(params.vk, [z + 1], proof)
    assert not groth16_verify(params.vk, [z, 0], proof)
    bad = G1Wire((proof.a.x + 1) % (2**381), proof.a.y, proof.a.infinity)
    assert not groth16_verify(params.vk, [z],
                              dataclasses.replace(proof, a=bad))
    # an unsatisfied witness proves, but does not verify
    cs_bad, _ = multiply_circuit(3, 5, z=999)
    bad_proof = create_proof(params, cs_bad, r=7, s=11, device="cpu")
    assert not groth16_verify(params.vk, [999], bad_proof)


def test_dedup_plan_error_reaches_caller(params, monkeypatch):
    """The dedup plans are built on a worker thread during the h phase; an
    error there is raised by create_proof, not swallowed."""
    def broken(z_np, threshold=8):
        raise MemoryError("plan worker failed")

    monkeypatch.setattr(tprove.msm, "make_dedup_plan", broken)
    cs, _ = multiply_circuit(3, 5)
    with pytest.raises(MemoryError, match="plan worker failed"):
        create_proof(params, cs, r=7, s=11, device="cpu")


def _same_params(a, b):
    assert ser.dumps(a.vk) == ser.dumps(b.vk)
    for f in ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2",
              "num_inputs"):
        assert getattr(a.pk, f) == getattr(b.pk, f)
    for name in QUERIES:
        (am_a, inf_a), (am_b, inf_b) = getattr(a.pk, name), getattr(b.pk, name)
        # a toy key lives on the device, narrow: int16 limbs, uint8 flags
        for am, inf in ((am_a, inf_a), (am_b, inf_b)):
            assert am.dtype == torch.int16 and inf.dtype == torch.uint8
        assert torch.equal(am_a, am_b) and torch.equal(inf_a, inf_b)


def test_params_from_numpy_matches_loader(params):
    j = jk.load_parameters(PINNED, backend="np")

    def wire(w):
        return (tuple(w.x) if isinstance(w.x, tuple) else w.x,
                tuple(w.y) if isinstance(w.y, tuple) else w.y, w.infinity)

    vk = j.vk
    head = {f: getattr(j.pk, f) for f in ("alpha_g1", "beta_g1", "beta_g2",
                                           "delta_g1", "delta_g2",
                                           "num_inputs")}
    head["vk"] = (wire(vk.alpha_g1), wire(vk.beta_g1), wire(vk.beta_g2),
                  wire(vk.gamma_g2), wire(vk.delta_g1), wire(vk.delta_g2),
                  [wire(p) for p in vk.ic])
    queries = {n: tuple(np.asarray(a) for a in getattr(j.pk, n))
               for n in QUERIES}
    assert queries["a_query"][0].dtype == np.uint16
    _same_params(tk.params_from_numpy(head, queries, device="cpu"), params)
    # the limbs are the JAX package's, bit for bit
    am, _ = params.pk.b_g2_query
    assert np.array_equal(to_numpy(am), queries["b_g2_query"][0])


def test_directory_layout_loads(params, tmp_path):
    jk.save_parameters(jk.load_parameters(PINNED, backend="np"),
                       str(tmp_path / "key"))
    _same_params(tk.load_parameters(str(tmp_path / "key"), device="cpu"),
                 params)


def test_key_header_refuses_other_classes(tmp_path):
    class Evil:
        def __reduce__(self):
            return (os.system, ("true",))

    path = tmp_path / "key"
    path.mkdir()
    (path / "head.pkl").write_bytes(pickle.dumps({"vk": Evil()}))
    with pytest.raises(pickle.UnpicklingError):
        tk.load_parameters(str(path), device="cpu")


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tk.load_parameters(PINNED)
