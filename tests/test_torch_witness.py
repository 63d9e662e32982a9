"""The witness encode's native pass (`bazuka_tpu_torch/groth16/witness.py`,
`csrc/witness.cpp`) on the CPU.

- Its limbs equal `ints_to_array([v % P for v in vals], 16)` bit for bit
  for random values below r and the edges 0, 1, r - 1, r, r + 5, 2^255,
  2^256 + 3, -1 and -r - 7; it counts `witness.reduced` once for each
  value it had to reduce.
- On a constraint system whose public inputs are allocated between its aux
  variables, the scatter to `_remap()`'s rows gives `full_assignment()`'s
  input-major order, with the padding rows zero, as the bytes path does.
- A None value (a system not in proving mode) raises SynthesisError, a
  float or a str raises TypeError, a row outside the buffer ValueError,
  a length other than the circuit's SynthesisError.
- The toy key's proof at pinned (r, s) is the pinned bytes with the native
  pass and with the loader forced to None; the bytes path counts
  `witness.fallback` 1, the native pass neither counter.  The sharded
  prover's toy proof is unchanged.

The native pass needs a C++ compiler and this interpreter's `Python.h`;
where either is missing, the tests that need it skip and say which.
"""

import os
import random
import shutil
import sysconfig

import numpy as np
import pytest
import torch

import chip_smoke
from bazuka_tpu_torch import parallel as par
from bazuka_tpu_torch.fields.host import FR_MODULUS
from bazuka_tpu_torch.fields.limbs import ints_to_array
from bazuka_tpu_torch.groth16 import keygen, prove, witness
from bazuka_tpu_torch.groth16.r1cs import ConstraintSystem, SynthesisError
from bazuka_tpu_torch.utils import ser, spans

# The toy shapes are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

P = FR_MODULUS
EDGES = [0, 1, P - 1, P, P + 5, 1 << 255, (1 << 256) + 3, -1, -P - 7]
N_REDUCED = 6  # P, P + 5, 2^255, 2^256 + 3, -1, -P - 7


@pytest.fixture
def native():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no C++ compiler to build csrc/witness.cpp")
    if not os.path.exists(os.path.join(sysconfig.get_paths()["include"],
                                       "Python.h")):
        pytest.skip("no Python.h for this interpreter")
    assert witness.load_encoder() is not None
    return witness.load_encoder()


@pytest.fixture
def bytes_path(monkeypatch):
    monkeypatch.setattr(witness, "load_encoder", lambda: None)


class Plain:
    """A `cs` with only `full_assignment()`: encoded in its own order."""

    def __init__(self, vals):
        self.vals = vals

    def full_assignment(self):
        return self.vals


def newest(name):
    return [c for c in spans.snapshot() if c["name"] == name][-1]


def reference(vals, n_rows):
    want = np.zeros((n_rows, 16), np.uint32)
    want[:len(vals)] = ints_to_array([v % P for v in vals], 16)
    return want


def interleaved_circuit():
    """Aux variables allocated before, between and after two public
    inputs, so `_remap()` is not the identity."""
    cs = ConstraintSystem(proving=True)
    rnd = random.Random(7)
    for k in range(9):
        if k in (2, 6):
            cs.alloc_input(rnd.randrange(P))
        cs.alloc(rnd.randrange(P) if k % 2 else k)
    return cs


def test_limbs_bit_exact_and_reductions_counted(native):
    rnd = random.Random(2024)
    vals = [rnd.randrange(P) for _ in range(500)] + EDGES
    with spans.call("witness-test"):
        rows = witness.encode_assignment(Plain(vals), len(vals),
                                         len(vals) + 3)
    assert rows.dtype == np.uint16 and rows.shape == (len(vals) + 3, 16)
    assert np.array_equal(rows, reference(vals, len(vals) + 3))
    c = newest("witness-test")
    assert c["counts"]["witness.reduced"] == N_REDUCED
    assert "witness.fallback" not in c["counts"]
    with spans.call("witness-test"):  # canonical values: no count
        witness.encode_assignment(Plain(vals[:500]), 500, 500)
    assert "witness.reduced" not in newest("witness-test")["counts"]


@pytest.mark.parametrize("path", ["native", "bytes_path"])
def test_scatter_gives_input_major_order(path, request):
    request.getfixturevalue(path)
    cs = interleaved_circuit()
    remap = cs._remap()
    assert not np.array_equal(remap, np.arange(remap.shape[0]))
    n = len(cs.assignment)
    rows = witness.encode_assignment(cs, n, n + 5)
    assert np.array_equal(rows, reference(cs.full_assignment(), n + 5))
    assert not rows[n:].any()


def test_bad_values_raise(native, monkeypatch):
    setup = ConstraintSystem(proving=False)
    setup.alloc()
    with pytest.raises(SynthesisError, match="proving mode"):
        witness.encode_assignment(setup, 2, 4)
    for bad in (2.5, "7"):
        with pytest.raises(TypeError, match="not int"):
            witness.encode_assignment(Plain([1, bad, 3]), 3, 4)
        cs = interleaved_circuit()
        cs.assignment[3] = bad
        with pytest.raises(TypeError):
            witness.encode_assignment(cs, len(cs.assignment), 16)
    with pytest.raises(SynthesisError, match="shape mismatch"):
        witness.encode_assignment(Plain([1, 2]), 3, 4)
    cs = interleaved_circuit()
    n = len(cs.assignment)
    monkeypatch.setattr(cs, "_remap", lambda: np.arange(n) + 1)
    with pytest.raises(ValueError, match="row"):
        witness.encode_assignment(cs, n, n)


def test_bytes_path_raises_alike(bytes_path):
    setup = ConstraintSystem(proving=False)
    setup.alloc()
    with pytest.raises(SynthesisError, match="proving mode"):
        witness.encode_assignment(setup, 2, 4)
    with pytest.raises(SynthesisError, match="shape mismatch"):
        witness.encode_assignment(Plain([1, 2]), 3, 4)


@pytest.fixture(scope="module")
def toy_params():
    return keygen.load_parameters(chip_smoke.TOY_KEY, device="cpu")


@pytest.mark.parametrize("path", ["native", "bytes_path"])
def test_toy_proof_bytes_on_either_path(path, request, toy_params):
    request.getfixturevalue(path)
    cs, _ = chip_smoke.toy_circuit()
    proof = prove.create_proof(toy_params, cs, r=7, s=11, device="cpu")
    assert ser.dumps(proof).hex() == chip_smoke.TOY_PROOF_HEX
    counts = newest("create_proof")["counts"]
    assert counts.get("witness.fallback") == (
        1 if path == "bytes_path" else None)
    assert "witness.reduced" not in counts


def test_toy_sharded_proof_unchanged(native, toy_params):
    cs, _ = chip_smoke.toy_circuit()
    proof = par.create_proof_sharded(toy_params, cs,
                                     par.make_mesh(2, ["cpu"]), r=7, s=11)
    assert ser.dumps(proof).hex() == chip_smoke.TOY_PROOF_HEX
