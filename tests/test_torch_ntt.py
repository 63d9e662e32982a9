"""Port parity: `bazuka_tpu_torch.ops.ntt` against `bazuka_tpu.ops.ntt`
(`ntt_host` and the JAX `ntt_mont`) at log_n 4 and 8, forward, inverse and
on the coset gH.  The JAX transforms consume their input; the port's must
leave the caller's tensor unchanged."""

import numpy as np
import pytest
import torch

from bazuka_tpu.fields.host import FR_GENERATOR, FR_MODULUS
from bazuka_tpu.fields.limbs import fr_field as j_fr
from bazuka_tpu.ops import ntt as jn
from bazuka_tpu_torch.fields.limbs import fr_field, to_numpy
from bazuka_tpu_torch.ops import ntt as tn

# The shapes here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

P = FR_MODULUS


def rand_vals(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


@pytest.mark.parametrize("log_n", [4, 8])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_matches_host_and_jax(log_n, inverse):
    F = fr_field()
    vals = rand_vals(1 << log_n, log_n + 10 * inverse)
    x = F.encode(vals, device="cpu")
    before = x.clone()
    got = tn.ntt_mont(x, inverse)
    assert (x == before).all(), "ntt_mont changed its input"
    assert [int(v) for v in F.decode(got)] == jn.ntt_host(vals, inverse)
    Fj = j_fr("jax")
    want = jn.ntt_mont(Fj.xp.asarray(Fj.encode(vals)), inverse, "jax")
    assert np.array_equal(to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("log_n", [4, 8])
def test_coset_roundtrip_and_values(log_n):
    F = fr_field()
    n = 1 << log_n
    coeffs = rand_vals(n, 100 + log_n)
    x = F.encode(coeffs, device="cpu")
    before = x.clone()
    ev = tn.coset_ntt_mont(x)
    assert (x == before).all()
    # evaluations on gH: f(g·w^i)
    g, w = FR_GENERATOR, tn.root_of_unity(log_n)
    pts = [g * pow(w, i, P) % P for i in range(n)]
    want = [sum(c * pow(t, k, P) for k, c in enumerate(coeffs)) % P
            for t in pts[:8]]
    assert [int(v) for v in F.decode(ev)][:8] == want
    Fj = j_fr("jax")
    jev = jn.coset_ntt_mont(Fj.xp.asarray(Fj.encode(coeffs)), "jax")
    assert np.array_equal(to_numpy(ev), np.asarray(jev))
    ev_before = ev.clone()
    back = tn.coset_intt_mont(ev)
    assert (ev == ev_before).all()
    assert [int(v) for v in F.decode(back)] == coeffs
    jback = jn.coset_intt_mont(Fj.xp.asarray(np.asarray(jev)), "jax")
    assert np.array_equal(to_numpy(back), np.asarray(jback))


def test_rejects_non_power_of_two():
    F = fr_field()
    with pytest.raises(ValueError):
        tn.ntt_mont(F.encode(rand_vals(12, 1), device="cpu"))


@pytest.fixture
def fourstep_forced(monkeypatch):
    """The four-step from 2^4 up, over chunks of 2^6 elements (several per
    pass), in both packages (as tests/test_ntt.py forces it)."""
    for mod in (jn, tn):
        monkeypatch.setattr(mod, "_FOURSTEP_MIN_LOG_N", 4)
        monkeypatch.setattr(mod, "_FOURSTEP_CHUNK_LANES", 1 << 6)


@pytest.mark.parametrize("log_n", [5, 8])  # A != B, A = B
@pytest.mark.parametrize("inverse", [False, True])
def test_fourstep_matches_jax(fourstep_forced, log_n, inverse):
    F, Fj = fr_field(), j_fr("jax")
    vals = rand_vals(1 << log_n, 200 + log_n + 10 * inverse)
    x = F.encode(vals, device="cpu")
    before = x.clone()
    got = tn._ntt_mont_fourstep(x, log_n, inverse)
    assert (x == before).all(), "the four-step changed its input"
    want = jn._ntt_mont_fourstep(Fj.xp.asarray(Fj.encode(vals)), log_n,
                                 inverse, "jax")
    assert np.array_equal(to_numpy(got), np.asarray(want))
    # ntt_mont dispatches to it, and it is the transform
    assert torch.equal(tn.ntt_mont(x, inverse), got)
    assert [int(v) for v in F.decode(got)] == jn.ntt_host(vals, inverse)


@pytest.mark.parametrize("log_n", [5, 8])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("scale", [False, True])
def test_batched_matches_jax(log_n, inverse, scale):
    F, Fj = fr_field(), j_fr("jax")
    B = 3
    vals = rand_vals(B << log_n, 300 + log_n)
    x = F.encode(vals, device="cpu").view(B, 1 << log_n, F.n)
    got = tn.ntt_mont_batched(x, inverse, scale=scale)
    enc = Fj.xp.asarray(Fj.encode(vals).reshape(B, 1 << log_n, Fj.n))
    want = jn.ntt_mont_batched(enc, inverse, "jax", scale=scale)
    assert np.array_equal(to_numpy(got), np.asarray(want))


def test_tables_cached_only_up_to_the_limit(monkeypatch):
    """Tables of at most 2^_TABLE_CACHE_MAX_LOG_N rows are cached, larger
    ones rebuilt per call, with the same limbs."""
    monkeypatch.setattr(tn, "_TABLE_CACHE_MAX_LOG_N", 5)
    for build in (tn._stage_twiddles, tn._coset_scale):
        assert build(5, False, "cpu") is build(5, False, "cpu")
        a, b = build(6, True, "cpu"), build(6, True, "cpu")
        assert a is not b and torch.equal(a, b)
