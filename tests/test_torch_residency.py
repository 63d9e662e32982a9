"""The key residency policy (`bazuka_tpu_torch.groth16.keygen`'s
`device_queries`, the JAX package's) against the JAX package, on the CPU:
a synthetic circuit's key at d = 2^6 (2^8 in the slow tier) is made with
its queries on the host and again on the card (narrow), the two equal;
saved in the directory layout, it loads memory-mapped under True, "g1"
and False, and the three keys prove to the same bytes, which verify; the
JAX package's `load_parameters` reads the directory to the same head,
verifying key and queries.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from bazuka_tpu.groth16 import keygen as jk
from bazuka_tpu_torch.fields.limbs import to_numpy
from bazuka_tpu_torch.groth16 import keygen as tk
from bazuka_tpu_torch.groth16 import prove as tprove
from bazuka_tpu_torch.groth16.verify import groth16_verify
from bazuka_tpu_torch.utils import ser

# The shapes here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

SEED = b"residency"
PROOFS = {}  # (log_d, residency) -> proof bytes


@pytest.fixture(scope="module",
                params=[6, pytest.param(8, marks=pytest.mark.slow)],
                ids=["d64", "d256"])
def host_key(request, tmp_path_factory):
    """(log_d, circuit, key made with every query on the host, its saved
    directory)."""
    log_d = request.param
    cs = chip_smoke.SyntheticCircuit((1 << log_d) - 6, 22)
    params = tk.generate_parameters(cs, seed=SEED, device="cpu",
                                    device_queries=False)
    assert params.pk.a_query[0].shape[0] == 1 << log_d
    path = str(tmp_path_factory.mktemp("key") / f"key{log_d}")
    tk.save_parameters(params, path)
    return log_d, cs, params, path


def test_keys_on_the_card_equal_keys_on_the_host(host_key):
    _, cs, params, _ = host_key
    on_card = tk.generate_parameters(cs, seed=SEED, device="cpu",
                                     device_queries=True)
    for name in chip_smoke.QUERY_NAMES:
        am, inf = getattr(on_card.pk, name)
        ham, hinf = getattr(params.pk, name)
        assert am.dtype == torch.int16 and inf.dtype == torch.uint8
        assert isinstance(ham, np.ndarray) and ham.dtype == np.uint16
        assert np.array_equal(to_numpy(am), ham), name
        assert np.array_equal(inf.numpy(), hinf), name
    assert ser.dumps(on_card.vk) == ser.dumps(params.vk)


@pytest.mark.parametrize("residency", [True, "g1", False])
def test_residency_keeps_proof_bytes(host_key, residency):
    log_d, cs, params, path = host_key
    loaded = tk.load_parameters(path, device="cpu", device_queries=residency)
    for name in chip_smoke.QUERY_NAMES:
        am, inf = getattr(loaded.pk, name)
        if tk._resident(residency, name):
            assert am.dtype == torch.int16 and inf.dtype == torch.uint8
        else:  # a host query stays on disk until its MSM uploads it
            assert isinstance(am, np.memmap) and isinstance(inf, np.memmap)
    assert ser.dumps(loaded.vk) == ser.dumps(params.vk)
    proof = tprove.create_proof(loaded, cs, r=7, s=11, device="cpu")
    PROOFS[(log_d, residency)] = ser.dumps(proof)
    assert len({v for (d, _), v in PROOFS.items() if d == log_d}) == 1
    if residency is False:  # the proof is right, not only the same
        x = cs.z[1]
        assert groth16_verify(loaded.vk, [x], proof)
        assert not groth16_verify(loaded.vk, [x + 1], proof)


def test_jax_loads_the_port_directory(host_key):
    _, _, params, path = host_key
    j = jk.load_parameters(path, backend="np", device_queries=False)
    for f in ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2",
              "num_inputs"):
        assert getattr(j.pk, f) == getattr(params.pk, f), f

    def wires(vk):
        return [(w.x, w.y, w.infinity) for w in (
            vk.alpha_g1, vk.beta_g1, vk.beta_g2, vk.gamma_g2, vk.delta_g1,
            vk.delta_g2, *vk.ic)]

    assert wires(j.vk) == wires(params.vk)
    for name in chip_smoke.QUERY_NAMES:
        (jam, jinf), (am, inf) = getattr(j.pk, name), getattr(params.pk, name)
        assert np.array_equal(np.asarray(jam), am), name
        assert np.array_equal(np.asarray(jinf), inf), name
