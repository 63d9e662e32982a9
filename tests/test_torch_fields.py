"""Port parity: `bazuka_tpu_torch.fields.limbs.LimbField` on the CPU against
`bazuka_tpu.fields.limbs.LimbField` ("np" and "jax" backends), limb for
limb, and the plain version of kernel K1 against the JAX package's Pallas
Montgomery multiply run in interpret mode.

The cases follow tests/test_fields.py.  Inputs are made with a seeded
`random.Random` and handed to both packages as the same integers."""

import random

import numpy as np
import pytest
import torch

from bazuka_tpu.fields import limbs as jl
from bazuka_tpu.fields.host import FP, FR
from bazuka_tpu_torch.fields import limbs as tl
from bazuka_tpu_torch.ops.field_kernel import mont_mul_plain

# The shapes here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

rng = random.Random(0xBA2)
CPU = "cpu"


@pytest.fixture(scope="module", params=["fr", "fp"])
def fields(request):
    if request.param == "fr":
        return tl.fr_field(), jl.fr_field("np"), FR
    return tl.fp_field(), jl.fp_field("np"), FP


def rand_elems(p, k):
    return [rng.randrange(p) for _ in range(k)]


def same(t: torch.Tensor, ref) -> bool:
    """Port int32 limbs hold the same bits as the JAX package's uint32."""
    return np.array_equal(tl.to_numpy(t), np.asarray(ref, np.uint32))


def test_encode_decode(fields):
    T, J, _ = fields
    xs = rand_elems(T.p, 17)
    enc = T.encode(xs, device=CPU)
    assert enc.dtype == torch.int32 and tuple(enc.shape) == (17, T.n)
    assert same(enc, J.encode(xs))
    assert same(T.encode(xs, mont=False, device=CPU), J.encode(xs, mont=False))
    assert [int(v) for v in T.decode(enc)] == xs


def test_add_sub_neg(fields):
    T, J, H = fields
    a = rand_elems(T.p, 33) + [0, T.p - 1]
    b = rand_elems(T.p, 33) + [0, 1]
    ta, tb = T.encode(a, device=CPU), T.encode(b, device=CPU)
    ja, jb = J.encode(a), J.encode(b)
    assert same(T.add(ta, tb), J.add(ja, jb))
    assert same(T.sub(ta, tb), J.sub(ja, jb))
    assert same(T.neg(ta), J.neg(ja))
    assert list(T.decode(T.add(ta, tb))) == [H.add(x, y) for x, y in zip(a, b)]


def test_mul(fields):
    T, J, H = fields
    edge = [0, 1, 2, T.p - 1, T.p - 2, T.R_mod_p, (1 << 255) % T.p]
    a = edge + rand_elems(T.p, 40)
    b = list(reversed(edge)) + rand_elems(T.p, 40)
    ta, tb = T.encode(a, device=CPU), T.encode(b, device=CPU)
    ja, jb = J.encode(a), J.encode(b)
    assert same(T.mont_mul(ta, tb), J.mont_mul(ja, jb))
    assert same(T.mont_sqr(ta), J.mont_sqr(ja))
    assert list(T.decode(T.mont_mul(ta, tb))) == [
        H.mul(x, y) for x, y in zip(a, b)
    ]
    # a broadcast operand (a constant row) gives the same limbs
    c = T.encode(b[5], device=CPU)
    assert same(T.mont_mul(ta, c), J.mont_mul(ja, J.encode(b[5])[None]))


def test_inv_pow(fields):
    T, J, H = fields
    a = rand_elems(T.p, 9) + [1, T.p - 1, 0]
    ta, ja = T.encode(a, device=CPU), J.encode(a)
    assert same(T.inv_mont(ta), J.inv_mont(ja))
    assert list(T.decode(T.inv_mont(ta))) == [H.inv(x) if x else 0 for x in a]
    e = 0xDEADBEEFCAFEBABE
    assert same(T.pow_mont(ta, e), J.pow_mont(ja, e))


def test_predicates_select(fields):
    T, _, _ = fields
    a = T.encode([0, 1, 5, 0], device=CPU)
    b = T.encode([0, 1, 6, 1], device=CPU)
    assert T.is_zero(a).tolist() == [True, False, False, True]
    assert T.eq(a, b).tolist() == [True, True, False, False]
    cond = torch.tensor([True, False, True, False])
    assert [int(v) for v in T.decode(T.select(cond, a, b))] == [0, 1, 5, 1]


def test_to_from_mont(fields):
    T, J, _ = fields
    xs = rand_elems(T.p, 8)
    raw_t, raw_j = T.encode(xs, mont=False, device=CPU), J.encode(xs, mont=False)
    m = T.to_mont(raw_t)
    assert same(m, J.to_mont(raw_j))
    assert same(T.from_mont(m), J.from_mont(J.to_mont(raw_j)))
    assert list(T.decode(T.from_mont(m), mont=False)) == xs
    assert same(T.const_mont(xs[0], device=CPU), J.const_mont(xs[0]))


def test_small_modulus_exhaustive():
    """Tiny-modulus cross-check under the Mersenne prime 2^17 - 1."""
    p = 131071
    T = tl.LimbField(p, 3, "tiny")
    J = jl.LimbField(p, 3, "tiny", backend="np")
    xs = list(range(0, p, 641)) + [0, 1, p - 1]
    ta = T.encode(xs, device=CPU)
    for shift, name, ref in [
        (1, "add", lambda x, y: (x + y) % p),
        (3, "sub", lambda x, y: (x - y) % p),
        (5, "mont_mul", lambda x, y: (x * y) % p),
    ]:
        ys = xs[shift:] + xs[:shift]
        got = getattr(T, name)(ta, T.encode(ys, device=CPU))
        assert same(got, getattr(J, name)(J.encode(xs), J.encode(ys)))
        assert list(T.decode(got)) == [ref(x, y) for x, y in zip(xs, ys)]


def test_matches_jax_backend():
    """The jitted JAX engine gives the same limbs as the port."""
    import jax

    Fj = jl.fr_field("jax")
    T = tl.fr_field()
    xs = rand_elems(T.p, 8)
    ys = rand_elems(T.p, 8)

    @jax.jit
    def ops(a, b):
        return (Fj.add(a, b), Fj.sub(a, b), Fj.mont_mul(a, b), Fj.neg(a))

    got = ops(Fj.xp.asarray(Fj.encode(xs)), Fj.xp.asarray(Fj.encode(ys)))
    ta, tb = T.encode(xs, device=CPU), T.encode(ys, device=CPU)
    want = (T.add(ta, tb), T.sub(ta, tb), T.mont_mul(ta, tb), T.neg(ta))
    for g, w in zip(got, want):
        assert same(w, np.asarray(g))


def test_wrapper_rejects_other_devices():
    T = tl.fr_field()
    a = T.encode([1, 2], device=CPU)
    with pytest.raises(ValueError):
        T.mont_mul(a, a.to("meta"))


def _k1_against_pallas(T, J, n):
    """K1's plain version equals the Pallas kernel body (interpret mode)
    on the same seeded inputs."""
    from bazuka_tpu.ops.pallas_field import pallas_mont_mul

    gen = np.random.default_rng(n)
    top = (T.p >> (16 * (T.n - 1))) & 0xFFFF
    a = gen.integers(0, 1 << 16, size=(n, T.n), dtype=np.uint32)
    b = gen.integers(0, 1 << 16, size=(n, T.n), dtype=np.uint32)
    a[:, -1] %= top
    b[:, -1] %= top
    a[0] = 0
    a[1] = b[1] = jl.int_to_limbs(T.p - 1, T.n)
    want = np.asarray(pallas_mont_mul(J, J.xp.asarray(a), J.xp.asarray(b),
                                      interpret=True))
    got = mont_mul_plain(T, tl.to_torch(a, CPU), tl.to_torch(b, CPU))
    assert same(got, want)


def test_k1_plain_matches_pallas_interpret_fr():
    _k1_against_pallas(tl.fr_field(), jl.fr_field("jax"), 1024)


@pytest.mark.slow
def test_k1_plain_matches_pallas_interpret_fp():
    _k1_against_pallas(tl.fp_field(), jl.fp_field("jax"), 1024)
