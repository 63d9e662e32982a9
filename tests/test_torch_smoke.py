"""The port stands alone, and `chip_smoke.py`'s real-size proof phase holds
at a tiny size on the CPU.

- Importing every `bazuka_tpu_torch` module and `chip_smoke` adds no `jax`
  and no `bazuka_tpu` module to `sys.modules` (compared before and after,
  since a host may pre-import jax).
- `chip_smoke.py` exits non-zero and prints no result without a CUDA
  device, and alone in a directory without the package.
- The real-size proof phase at d = 2^6: the synthetic circuit and known-log
  key prove to the host-computed (A, B, C), the h identity holds, and a
  tampered h fails it.
- The h identity sums a(ρ), b(ρ), c(ρ) from the circuit's terms, so a row
  evaluation fault that keeps a∘b = c still fails it.
- The keygen phase's spot check at d = 2^4: a key generated on the CPU
  passes it, and fails it once one sampled query point is replaced by its
  double.
"""

import json
import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import torch

import bazuka_tpu_torch
import chip_smoke
from bazuka_tpu_torch.crypto import bls12_381 as bls
from bazuka_tpu_torch.fields.limbs import fp_field, fr_field
from bazuka_tpu_torch.groth16 import keygen, qap
from bazuka_tpu_torch.groth16.prove import _pad_rows, compute_h_mont, create_proof
from bazuka_tpu_torch.groth16.sparse import DeviceR1CS, encode_mont

# The shapes here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    mods = sorted(m.name for m in pkgutil.walk_packages(
        bazuka_tpu_torch.__path__, "bazuka_tpu_torch."))
    assert "bazuka_tpu_torch.ops.msm_lm" in mods
    code = (
        "import importlib, json, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "added = sorted(set(sys.modules) - before)\n"
        "print(json.dumps(added))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    added = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in added
           if m.split(".")[0] in ("jax", "jaxlib", "bazuka_tpu")]
    assert not bad, bad
    assert "bazuka_tpu_torch.groth16.prove" in added


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_chip_smoke_fails_without_cuda_or_package(tmp_path):
    res = _run_smoke(ROOT)
    assert res.returncode == 2
    assert '"ok"' not in res.stdout
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    alone = _run_smoke(tmp_path)
    assert alone.returncode != 0
    assert '"ok"' not in alone.stdout


def test_real_size_phase_at_tiny_size():
    cs, params, sc, d = chip_smoke.real_size_setup(6, "cpu")
    assert d == 64 and cs.compiled().num_vars == cs.n_constraints + 2
    record = {}
    proof = create_proof(params, cs, r=3, s=4, device="cpu", record=record)
    assert record["n_heavy_vals"] >= 1
    checks = chip_smoke.check_real_proof(cs, params, sc, d, proof, record,
                                         3, 4, 123456789)
    assert all(checks.values()), checks
    h = record["h_std"].clone()
    h[0, 0] ^= 1
    assert not chip_smoke.h_identity_holds(cs.compiled(), cs.z, h, d,
                                           987654321)
    wrong = chip_smoke.expected_proof(cs.z, [1] * (d - 1), 2, sc, 3, 4)
    assert proof.c != chip_smoke.keygen.g1_wire(wrong[2])
    assert isinstance(record["seconds"]["msm_b_g2"], float)


def test_h_identity_catches_row_eval_fault():
    cs = chip_smoke.SyntheticCircuit(49, chip_smoke.ROOT_SEED)
    comp, d, rho = cs.compiled(), 64, 555555555
    dr = DeviceR1CS(comp, "cpu")
    z_mont = encode_mont(cs.z, "cpu")
    evs = [_pad_rows(p.eval(z_mont, dr.pal_mont), d) for p in dr.row_plans]
    h = compute_h_mont([e.clone() for e in evs], d)
    assert chip_smoke.h_identity_holds(comp, cs.z, h, d, rho)
    # a chain row: zero its a and c evaluations, so a∘b = c still holds
    j = 30
    assert not (evs[0][j] == 0).all() and not (evs[2][j] == 0).all()
    evs[0][j] = 0
    evs[2][j] = 0
    F = fr_field()
    assert torch.equal(F.mont_mul(evs[0], evs[1]), evs[2])
    assert not chip_smoke.h_identity_holds(comp, cs.z,
                                           compute_h_mont(evs, d), d, rho)


def test_keygen_spot_check_at_tiny_size():
    cs = chip_smoke.SyntheticCircuit(13, chip_smoke.ROOT_SEED)
    comp = cs.compiled()
    d = qap.domain_size(comp.n_constraints, comp.num_inputs)
    assert d == 16
    params = keygen.generate_parameters(cs, seed=b"tiny", device="cpu")
    checks, n_rows = chip_smoke.key_spot_check(comp, params, b"tiny", d)
    assert all(checks.values()), checks
    assert n_rows == 4 * 16 + 14  # the l query has 13 valid rows + a pad
    # a wrong seed's scalars disagree with every query
    wrong, _ = chip_smoke.key_spot_check(comp, params, b"other", d)
    assert not any(wrong.values())
    # row 0 of the a query (always sampled; u_0 is the ONE column's sum)
    # replaced by its double
    am, inf = params.pk.a_query
    assert not inf[0]
    F = fp_field()
    pt = (int(F.decode(am[0, 0])), int(F.decode(am[0, 1])))
    am[0] = F.encode(np.array(bls.g1_double(pt), dtype=object), device="cpu")
    tampered, _ = chip_smoke.key_spot_check(comp, params, b"tiny", d)
    assert not tampered["a_query"]
    assert all(v for k, v in tampered.items() if k != "a_query")
