"""The port's `zk/wire.py` against the JAX package's, on the reference's
three ceremony VK blobs (copied to `bazuka_tpu_torch/zk/data/`):

- both packages decode each blob to equal keys, and `encode_vk` gives
  the blob back;
- `validate_vk_points` accepts each blob, and both packages give the same
  message for a G1 point off the curve, a G1 point outside the subgroup
  and a G2 point off the curve (tests/test_advice_fixes.py:36, 173-188);
- the port's toy proof (its bytes pinned in `chip_smoke.py`, which
  tests/test_torch_prove.py holds the port's prover to) round-trips
  through `encode_proof`/`decode_proof`, to the JAX package's bytes;
- `load_mainnet_vks` gives the same keys in both packages.
"""

import dataclasses
import importlib.resources as res

import pytest
import torch

import chip_smoke
from bazuka_tpu.zk import wire as jwire
from bazuka_tpu_torch.config.blockchain import load_mainnet_vks
from bazuka_tpu_torch.crypto import bls12_381 as bls
from bazuka_tpu_torch.utils import ser
from bazuka_tpu_torch.zk import wire
from bazuka_tpu_torch.zk.proof import G1Wire, G2Wire, Groth16Proof

torch.set_num_threads(1)

NAMES = ("deposit", "withdraw", "update")


def blob(pkg: str, name: str) -> bytes:
    return (res.files(f"{pkg}.zk") / "data" / f"mpn_{name}_vk.bin").read_bytes()


def plain(vk) -> tuple:
    """A VK of either package as nested tuples of ints and bools."""
    return tuple(
        tuple(tuple(dataclasses.astuple(p)) for p in v) if isinstance(v, list)
        else dataclasses.astuple(v)
        for v in (getattr(vk, f.name) for f in dataclasses.fields(vk)))


@pytest.mark.parametrize("name", NAMES)
def test_vk_blob_decodes_to_the_jax_key(name):
    raw = blob("bazuka_tpu_torch", name)
    assert raw == blob("bazuka_tpu", name)
    vk, jvk = wire.decode_vk(raw), jwire.decode_vk(raw)
    assert plain(vk) == plain(jvk)
    assert len(vk.ic) == 6
    assert wire.encode_vk(vk) == raw
    assert wire.validate_vk_points(vk) is None
    with pytest.raises(wire.WireFormatError):
        wire.decode_vk(raw + b"\0")


def _non_subgroup_g1():
    """The first point of x = 2, 3, .. on y^2 = x^3 + 4 outside the prime
    order subgroup (tests/test_advice_fixes.py:158)."""
    x = 2
    while True:
        rhs = (x ** 3 + 4) % bls.P
        y = pow(rhs, (bls.P + 1) // 4, bls.P)
        if y * y % bls.P == rhs and not bls.g1_in_subgroup((x, y)):
            return x, y
        x += 1


def _bad_keys(vk, wire_mod):
    """The update VK with one point made invalid, three ways."""
    a = vk.alpha_g1
    x, y = _non_subgroup_g1()
    d2 = vk.delta_g2
    g1, g2 = type(a), type(d2)
    ic = list(vk.ic)
    ic[2] = g1(x, y, False)
    return {
        "g1_off_curve": dataclasses.replace(
            vk, alpha_g1=g1(a.x, (a.y + 1) % bls.P, False)),
        "g1_outside_subgroup": dataclasses.replace(vk, ic=ic),
        "g2_off_curve": dataclasses.replace(
            vk, delta_g2=g2(((d2.x[0] + 1) % bls.P, d2.x[1]), d2.y, False)),
    }


def test_validation_messages_equal_jax():
    raw = blob("bazuka_tpu_torch", "update")
    port = _bad_keys(wire.decode_vk(raw), wire)
    jax = _bad_keys(jwire.decode_vk(raw), jwire)
    msgs = {k: wire.validate_vk_points(v) for k, v in port.items()}
    assert msgs == {k: jwire.validate_vk_points(v) for k, v in jax.items()}
    assert msgs == {"g1_off_curve": "alpha_g1 not on curve",
                    "g1_outside_subgroup": "ic[2] not in subgroup",
                    "g2_off_curve": "delta_g2 not on curve"}


def test_toy_proof_round_trips():
    from bazuka_tpu.zk import proof as jproof
    from bazuka_tpu.utils import ser as jser

    raw = bytes.fromhex(chip_smoke.TOY_PROOF_HEX)
    proof = ser.loads(Groth16Proof, raw)
    enc = wire.encode_proof(proof)
    assert wire.decode_proof(enc) == proof
    assert enc == jwire.encode_proof(jser.loads(jproof.Groth16Proof, raw))
    assert isinstance(proof.a, G1Wire) and isinstance(proof.b, G2Wire)
    with pytest.raises(wire.WireFormatError):
        wire.decode_proof(enc[:-1])


def test_mainnet_vks_equal_jax():
    from bazuka_tpu.config.blockchain import load_mainnet_vks as jload

    port, jax = load_mainnet_vks(), jload()
    assert set(port) == set(NAMES) == set(jax)
    for name in NAMES:
        assert port[name].kind == "groth16"
        assert plain(port[name].vk) == plain(jax[name].vk)
