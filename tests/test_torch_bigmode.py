"""The port's big mode and key residency (`bazuka_tpu_torch.groth16.prove`
from BIG_DOMAIN up, `keygen`'s `device_queries`) against the JAX package,
on the CPU at toy sizes:

- the narrow form: limbs 0, 1, 0x7FFF, 0x8000 and 0xFFFF (and flags) go
  narrow and back unchanged, on the device and from host arrays, and the
  host narrowing equals the JAX package's `_narrow_np`;
- `_g2_msm_big` (the presum over the narrow query, two half drains)
  equals `msm_lm_g2` and the naive host sum, with and without a dedup
  plan; it and `msm_lm` free scalars handed over in a list before their
  drains;
- the committed toy key's proof at r = 7, s = 11 in big mode (BIG_DOMAIN
  1, the four-step forced), with the queries on the card and on the host,
  has the pinned JAX bytes (the JAX package's own test holds its big-mode
  proof equal to its normal one);
- the h phase's limbs are the same with its polynomials parked.

A CPU proof costs about 20 s here (the plain MSMs), so the residency
policies' proofs are in tests/test_torch_residency.py.
"""

import weakref

import numpy as np
import pytest
import torch

import chip_smoke
from bazuka_tpu.crypto import bls12_381 as jbls
from bazuka_tpu.groth16 import prove as jprove
from bazuka_tpu_torch.fields.limbs import (fr_field, narrow_limbs, narrow_np,
                                           narrow_to_device, to_numpy,
                                           widen_limbs)
from bazuka_tpu_torch.groth16 import keygen as tk
from bazuka_tpu_torch.groth16 import prove as tprove
from bazuka_tpu_torch.ops import msm_lm as tm
from bazuka_tpu_torch.ops import ntt as tn
from bazuka_tpu_torch.utils import ser

# The shapes here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

EDGE = [0, 1, 0x7FFF, 0x8000, 0xFFFF]


def test_narrow_round_trips():
    wide = torch.tensor([EDGE * 2] * 3, dtype=torch.int32)
    narrow = narrow_limbs(wide)
    assert narrow.dtype == torch.int16
    assert narrow.element_size() * narrow.numel() == wide.numel() * 2
    assert torch.equal(widen_limbs(narrow), wide)
    assert widen_limbs(wide) is wide and narrow_limbs(narrow) is narrow
    assert to_numpy(narrow).tolist() == to_numpy(wide).tolist()
    host = np.array([EDGE] * 2, np.uint32)
    assert np.array_equal(narrow_np(host), jprove._narrow_np(host))
    for a in (host, host.astype(np.uint16)):
        up = narrow_to_device(a, "cpu")
        assert up.dtype == torch.int16
        assert torch.equal(tprove._widen_u32(up),
                           torch.from_numpy(host.astype(np.int32)))
    flags = np.array([0, 1, 1, 0], np.uint32)
    assert np.array_equal(narrow_np(flags), jprove._narrow_np(flags))
    up = narrow_to_device(flags, "cpu")
    assert up.dtype == torch.uint8
    assert tprove._widen_u32(up).tolist() == [False, True, True, False]


def test_narrow_upload_in_slices(monkeypatch):
    """A host array larger than one upload slice arrives whole."""
    monkeypatch.setattr("bazuka_tpu_torch.fields.limbs._UPLOAD_BYTES", 100)
    rng = np.random.default_rng(5)
    a = rng.integers(0, 1 << 16, (37, 2, 24)).astype(np.uint16)
    assert to_numpy(narrow_to_device(a, "cpu")).tolist() == a.tolist()


def _g2_case(n, seed, heavy):
    rng = np.random.default_rng(seed)
    pts = [jbls.g2_mul(jbls.G2_GEN, k + 1) for k in range(n)]
    pts[3] = None
    if heavy:
        scalars = [1 if rng.random() < 0.5 else int(rng.integers(1, 2**62))
                   for _ in range(n)]
    else:
        scalars = [int(rng.integers(0, 2**62)) for _ in range(n)]
    return pts, scalars


@pytest.mark.parametrize("heavy", [False, True], ids=["plain", "dedup"])
def test_g2_msm_big_equals_msm_lm_g2(heavy):
    pts, scalars = _g2_case(16, 7 + heavy, heavy)
    P_am, inf = tm.points_to_am_g2(pts, device="cpu")
    s = tm.enc_scalars(scalars, device="cpu")
    plan = tm.make_dedup_plan(to_numpy(s), threshold=4) if heavy else None
    assert plan is None or plan.active
    want = tm.msm_lm_g2(P_am, inf, s, c=4, dedup_plan=plan)
    narrow = (narrow_limbs(P_am), inf.to(torch.uint8))
    before = s.clone()
    got = tprove._g2_msm_big(narrow, s, plan, c=4, chunk=8)
    assert torch.equal(s, before), "the caller's scalars were changed"
    assert got == want
    acc = None
    for p, k in zip(pts, scalars):
        acc = jbls.g2_add(acc, jbls.g2_mul(p, k))
    assert got == acc


@pytest.mark.parametrize("kind", ["g1", "g2_big"])
def test_msms_take_the_scalars_they_are_handed(monkeypatch, kind):
    """Scalars handed over in a one-element list: the MSM empties it, and
    once the dedup path has its zeroed copy no reference to the caller's
    tensor is left while the drains run."""
    n = 16
    pts, scalars = _g2_case(n, 9, heavy=True)
    if kind == "g1":
        pts = [jbls.g1_mul(jbls.G1_GEN, k + 1) for k in range(n)]
        P_am, inf = tm.points_to_am(pts, device="cpu")
    else:
        P_am, inf = tm.points_to_am_g2(pts, device="cpu")
    s = tm.enc_scalars(scalars, device="cpu")
    plan = tm.make_dedup_plan(to_numpy(s), threshold=4)
    assert plan.active
    add, mul = ((jbls.g1_add, jbls.g1_mul) if kind == "g1"
                else (jbls.g2_add, jbls.g2_mul))
    want = None
    for p, k in zip(pts, scalars):
        want = add(want, mul(p, k))
    alive = weakref.ref(s)
    seen = []
    drain = tm._msm_v3

    def spy(*args):
        seen.append(alive() is not None)
        return drain(*args)

    monkeypatch.setattr(tm, "_msm_v3", spy)
    box = [s]
    del s
    if kind == "g1":
        got = tm.msm_lm(P_am, inf, box, c=4, dedup_plan=plan)
    else:
        narrow = (narrow_limbs(P_am), inf.to(torch.uint8))
        got = tprove._g2_msm_big(narrow, box, plan, c=4, chunk=8)
    assert got == want and box == []
    # the heavy values' MSM runs first, the main drain(s) after the copy
    assert seen == [True] + [False] * (1 if kind == "g1" else 2)


@pytest.fixture
def big_mode(monkeypatch):
    """Big mode and the four-step at every size, the four-step over chunks
    of 2 elements."""
    monkeypatch.setattr(tprove, "BIG_DOMAIN", 1)
    monkeypatch.setattr(tn, "_FOURSTEP_MIN_LOG_N", 2)
    monkeypatch.setattr(tn, "_FOURSTEP_CHUNK_LANES", 2)


@pytest.mark.parametrize("residency", [True, False])
def test_big_mode_toy_proof_has_jax_bytes(big_mode, residency):
    params = tk.load_parameters(chip_smoke.TOY_KEY, device="cpu",
                                device_queries=residency)
    on_host = {n: isinstance(getattr(params.pk, n)[0], np.ndarray)
               for n in chip_smoke.QUERY_NAMES}
    assert on_host["b_g2_query"] == (residency is not True)
    assert on_host["a_query"] == (residency is False)
    cs, z = chip_smoke.toy_circuit()
    record = {}
    proof = tprove.create_proof(params, cs, r=7, s=11, device="cpu",
                                record=record)
    assert record["big_mode"] and "h_std" not in record
    assert ser.dumps(proof).hex() == chip_smoke.TOY_PROOF_HEX
    assert ("upload_b_g2" in record["seconds"]) == (residency is False)


def test_default_residency(monkeypatch):
    assert [tk.default_residency(1 << k) for k in (4, 22, 23, 24)] == [
        True, True, "g1", False]
    monkeypatch.setattr(tk, "RESIDENT_ALL_MAX", 16)
    monkeypatch.setattr(tk, "RESIDENT_G1_MAX", 32)
    assert [tk.default_residency(n) for n in (16, 32, 64)] == [
        True, "g1", False]


def test_h_phase_parks_in_big_mode(monkeypatch):
    """compute_h_mont's limbs are the same with its idle polynomials
    parked narrow and the four-step forced."""
    F = fr_field()
    rng = np.random.default_rng(11)
    d = 32
    evs = [F.encode([int.from_bytes(rng.bytes(32), "little") % F.p
                     for _ in range(d)], device="cpu") for _ in range(3)]
    want = tprove.compute_h_mont(list(evs), d)
    monkeypatch.setattr(tprove, "BIG_DOMAIN", 1)
    monkeypatch.setattr(tn, "_FOURSTEP_MIN_LOG_N", 3)
    monkeypatch.setattr(tn, "_FOURSTEP_CHUNK_LANES", 8)
    assert torch.equal(tprove.compute_h_mont(list(evs), d), want)
