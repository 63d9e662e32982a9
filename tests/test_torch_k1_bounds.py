"""The arithmetic of kernel K1 (`csrc/mont_ptx.cuh`, `csrc/mont_mul.cu`),
modelled in Python ints on the CPU, for both fields.

The CUDA code cannot run here, so this file holds its arithmetic instead:
- the constants of `mont_ptx.cuh`'s `FrMod` are Fr's p and -p^-1 mod 2^32,
  and Fr has no lazy headroom: 2p < R = 2^256 < 4p;
- a word-by-word model of the generic multiply `ptx::mul<M>` (CIOS over an
  even and a one-word-up accumulator, carry chains of 64-bit products)
  asserts, for Fr with canonical operands, that each dropped carry is 0,
  the accumulator stays below a + p < R, and the sum before the final
  subtract is below 2p, so one subtract of p makes it canonical; the same
  model over Fp's constants and lazy operands gives, word for word, the
  value of `tests/test_torch_madd_bounds.py`'s model of the K2-K5 schedule
  (the Fp multiply is unchanged);
- K1's batched multiply takes one operand below R (the row evaluation's
  redundant sums) by making the canonical one the multiplicand: that order
  holds every bound in both fields, and the model catches the other,
  whose accumulator overflows;
- the model catches a missing final subtract;
- Fr's canonical add and sub (the NTT's butterfly) and the multiply-high
  row index `row_of` of the batched multiply, at their edges;
- the inversion's window tables in `mont_mul.cu` are the sliding windows
  of p - 2 that `field_kernel.fermat_windows` computes, and the chain they
  drive, on lazy Fp values through the model, gives x^(p-2) in 463
  multiplies;
- the NTT's low-stage block size in `mont_mul.cu` is the plain version's,
  and the operation bounds that `chip_smoke.py` gives the NTT's stages and
  the inversion count what the function needs: the butterflies whose
  twiddle is not 1, and p - 2's squarings at a squaring's cost.
"""

import re

import numpy as np
import pytest

import test_torch_madd_bounds as fp_model
from bazuka_tpu_torch.fields.host import FP_MODULUS, FR_MODULUS
from bazuka_tpu_torch.ops import _cuda
from bazuka_tpu_torch.ops import field_kernel as fk

MASK = (1 << 32) - 1
PTX = (_cuda.CSRC / "mont_ptx.cuh").read_text()
MUL_CU = (_cuda.CSRC / "mont_mul.cu").read_text()


class Bound(AssertionError):
    pass


def check(cond, what):
    if not cond:
        raise Bound(what)


class Modulus:
    """One `struct ...Mod` of mont_ptx.cuh, read from the header."""

    def __init__(self, name):
        body = re.search(r"struct " + name + r" \{(.*?)\n\};", PTX,
                         re.S).group(1)
        self.nw = int(re.search(r"NW = (\d+);", body).group(1))
        self.pinv = int(re.search(r"PINV = 0x([0-9a-f]+)u", body).group(1),
                        16)
        words = re.search(r"p\(int j\) \{.*?\{(.*?)\};", body, re.S).group(1)
        self.p_words = [int(v, 16) for v in re.findall(r"0x([0-9a-f]+)u",
                                                       words)]
        self.p = sum(v << (32 * j) for j, v in enumerate(self.p_words))
        self.R = 1 << (32 * self.nw)


FR = Modulus("FrMod")
FP = Modulus("FpMod")


def _words(M, x):
    return [(x >> (32 * j)) & MASK for j in range(M.nw)]


def _from_words(w):
    return sum(v << (32 * j) for j, v in enumerate(w))


def _pairs(acc, c, terms, last_cc=True):
    """A carry chain of 64-bit products: for each (k, u, v, (lo, hi)),
    (acc[k+1]:acc[k]) = u*v + (hi:lo) + carry.  Returns the carry out
    (asserted 0 when the chain ends without one, `last_cc` False)."""
    for k, u, v, (lo, hi) in terms:
        prod = u * v
        s = lo + (prod & MASK) + c
        acc[k], c = s & MASK, s >> 32
        s = hi + (prod >> 32) + c
        acc[k + 1], c = s & MASK, s >> 32
    if not last_cc:
        check(c == 0, "a chain that ends drops no carry")
    return c


def _addc_top(y, c):
    s = y[-1] + c
    check(s >> 32 == 0, "addc into y's top word does not overflow")
    y[-1] = s


def mul(M, a, b, limit, b_limit=None):
    """ptx::mul<M>, word by word, for the multiplicand a below `limit` and
    b below `b_limit` (default `limit`): accumulators x (even pairs) and y
    (one word up); between steps t = o + (e >> 32).  Returns the sum
    before any final subtract."""
    check(0 <= a < limit and 0 <= b < (b_limit or limit),
          "mul operand in range")
    n = M.nw
    A, B = _words(M, a), _words(M, b)
    e, o = [0] * n, [0] * n
    for i in range(n):
        check(e[0] == 0, "e_0 is 0 between steps")
        check(_from_words(o) + (_from_words(e) >> 32) < a + M.p,
              "t < a + p at a step's start")
        bi = B[i]
        x, y = [0] * n, [0] * n
        s = o[0] + e[1]  # add.cc
        x[0], c = s & MASK, s >> 32
        c = _pairs(y, c, [(j - 1, A[j], bi, (e[j + 1], e[j + 2]))
                          for j in range(1, n - 1, 2)])
        _pairs(y, c, [(n - 2, A[n - 1], bi, (0, 0))], last_cc=False)
        x[1:] = o[1:]
        _addc_top(y, _pairs(x, 0, [(j, A[j], bi, (x[j], x[j + 1]))
                                   for j in range(0, n, 2)]))
        m = (x[0] * M.pinv) & MASK
        _addc_top(y, _pairs(x, 0, [(j, m, M.p_words[j], (x[j], x[j + 1]))
                                   for j in range(0, n, 2)]))
        check(x[0] == 0, "m zeroes x_0")
        c = _pairs(y, 0, [(j - 1, m, M.p_words[j], (y[j - 1], y[j]))
                          for j in range(1, n - 1, 2)])
        _pairs(y, c, [(n - 2, m, M.p_words[n - 1], (y[n - 2], y[n - 1]))],
               last_cc=False)
        e, o = x, y
    t = _from_words(o) + _from_words(e[1:] + [0])
    check(t < M.R, "o + (e >> 32): no carry out of the top word")
    check(t % M.p == a * b * pow(M.R, -1, M.p) % M.p, "t = a b / R mod p")
    return t


def mul_canon(a, b, final_subtract=True):
    """K1's Fr product (and the NTT's): canonical operands, the sum below
    2p, one conditional subtract of p; the result must be canonical."""
    t = mul(FR, a, b, FR.p)
    check(t < 2 * FR.p, "sum before the final subtract below 2p")
    r = t - FR.p if final_subtract and t >= FR.p else t
    check(r < FR.p, "K1's Fr result is canonical")
    return r


def add_canon(a, b):
    s = a + b
    check(s < FR.R, "add<FrMod, false>: no carry out of word 7")
    return s - FR.p if s >= FR.p else s


def sub_canon(a, b):
    d = (a - b) % FR.R
    if a < b:
        d = (d + FR.p) % FR.R
    return d


def row_of(e, d):
    """mont_mul.cu's row_of with the host's magic = ceil(2^32 / d)
    (2^32 - 1 for d = 1), in 32-bit arithmetic."""
    magic = MASK if d == 1 else ((1 << 32) + d - 1) // d
    q = (e * magic) >> 32
    r = (e - q * d) & MASK
    r = r - (1 << 32) if r >> 31 else r  # (int)
    if r < 0:
        r += d
    if r >= d:
        r -= d
    return r


def _rand(p, n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(48), "little") % p for _ in range(n)]


# ------------------------------------------------------------ the tests


def test_fr_constants():
    assert FR.nw == 8 and FR.p == FR_MODULUS
    assert (FR.p * FR.pinv) % (1 << 32) == MASK
    assert 2 * FR.p < FR.R < 4 * FR.p  # no lazy headroom
    assert FP.nw == 12 and FP.p == FP_MODULUS and 4 * FP.p < FP.R


FR_EDGE = [0, 1, 2, FR_MODULUS - 2, FR_MODULUS - 1]


def test_fr_mul_holds_its_bounds():
    """Every pair of edge values and 60 seeded random pairs, canonical."""
    rand = _rand(FR.p, 120, 7)
    pairs = [(a, b) for a in FR_EDGE for b in FR_EDGE] + list(
        zip(rand[::2], rand[1::2]))
    r_inv = pow(FR.R, -1, FR.p)
    for a, b in pairs:
        assert mul_canon(a, b) == a * b * r_inv % FR.p


def test_fr_butterfly_holds_its_bounds():
    """(u, v, w) -> (u + w v, u - w v), canonical, at the edges."""
    r_inv = pow(FR.R, -1, FR.p)
    vals = FR_EDGE + _rand(FR.p, 6, 8)
    for u in vals:
        for v in vals[:6]:
            t = mul_canon(v, FR.p - 1)
            assert add_canon(u, t) == (u + v * (FR.p - 1) * r_inv) % FR.p
            assert sub_canon(u, t) == (u - v * (FR.p - 1) * r_inv) % FR.p


def test_fp_schedule_unchanged():
    """The generic model over Fp's constants and lazy operands gives the
    same values as the K2-K5 model, and the header's Fp words are the
    ones that model reads."""
    assert FP.p_words == fp_model.P_WORDS and FP.pinv == fp_model.PINV
    edge = fp_model.EDGE
    rand = _rand(2 * FP.p, 40, 9)
    for a, b in [(a, b) for a in edge for b in edge] + list(
            zip(rand[::2], rand[1::2])):
        t = mul(FP, a, b, 2 * FP.p)
        assert t < 2 * FP.p and t == fp_model.mul(a, b)


@pytest.mark.parametrize("M", [FR, FP], ids=["fr", "fp"])
def test_k1_takes_one_operand_below_r(M):
    """mont_mul_kernel: the canonical operand is the multiplicand, the other
    any value below R; the sum stays below 2p and one subtract of p makes
    it canonical."""
    r_inv = pow(M.R, -1, M.p)
    canon = [0, 1, M.p - 1] + _rand(M.p, 4, 11)
    wide = [M.R - 1, M.R - M.p, M.p, M.p - 1] + _rand(M.R, 4, 12)
    for a in canon:
        for b in wide:
            t = mul(M, a, b, M.p, M.R)
            check(t < 2 * M.p, "sum before the final subtract below 2p")
            r = t - M.p if t >= M.p else t
            assert r == a * b * r_inv % M.p


@pytest.mark.parametrize("M", [FR, FP], ids=["fr", "fp"])
def test_model_catches_the_wrong_operand_order(M):
    """A multiplicand near R overflows the accumulator's top word."""
    with pytest.raises(Bound):
        mul(M, M.R - 1, M.p - 1, M.R)


def test_model_catches_a_missing_final_subtract():
    """Without its subtract of p, some Fr products leave [0, p)."""
    rand = _rand(FR.p, 200, 10)
    pairs = [(a, b) for a in FR_EDGE for b in FR_EDGE] + list(
        zip(rand[::2], rand[1::2]))
    caught = 0
    for a, b in pairs:
        try:
            mul_canon(a, b, final_subtract=False)
        except Bound:
            caught += 1
    assert caught > 0
    with pytest.raises(Bound):
        mul(FR, FR.p, 1, FR.p)  # a non-canonical operand


@pytest.mark.parametrize("d", [1, 2, 3, 7, 1 << 16, (1 << 21) + 1,
                               (1 << 22) - 1, 1 << 22, (1 << 31) - 1])
def test_row_index_without_division(d):
    es = {0, 1, d - 1, d, d + 1, 2 * d - 1, (1 << 31) - 1, (1 << 31) - 2,
          ((1 << 31) - 1) // d * d, 123456789}
    for e in sorted(x for x in es if 0 <= x < 1 << 31):
        assert row_of(e, d) == e % d, (e, d)


def _tables():
    first = int(re.search(r"INV_FIRST = (\d+);", MUL_CU).group(1))
    n = int(re.search(r"INV_STEPS = (\d+);", MUL_CU).group(1))

    def arr(name):
        body = re.search(name + r"\[INV_STEPS\] = \{(.*?)\};", MUL_CU,
                         re.S).group(1)
        return [int(v) for v in re.findall(r"\d+", body)]
    sq, dg = arr("INV_SQR"), arr("INV_DIGIT")
    assert len(sq) == len(dg) == n
    return first, list(zip(sq, dg))


def test_inversion_tables_are_the_windows_of_p_minus_2():
    first, steps = _tables()
    assert (first, steps) == fk.fermat_windows(FP_MODULUS - 2)
    assert all(d % 2 == 1 and d < 16 for _, d in steps) and first % 2 == 1
    # the table (x^2, then 7 odd powers) and one multiply per window
    assert 8 + sum(sq + 1 for sq, _ in steps) == 463
    # the chain's exponent is p - 2
    e = first
    for sq, d in steps:
        e = (e << sq) + d
    assert e == FP_MODULUS - 2


@pytest.mark.parametrize("x", [0, 1, FP_MODULUS - 1, 5],
                         ids=["0", "1", "p-1", "5"])
def test_inversion_chain_through_the_model(x):
    """mont_inv_fp_kernel's chain on the lazy model: table of odd powers,
    then the windows; canonical at the store."""
    p, R = FP.p, FP.R
    xm = x * R % p  # Montgomery form
    first, steps = _tables()
    x2 = mul(FP, xm, xm, 2 * p)
    tbl = [xm]
    for _ in range(7):
        tbl.append(mul(FP, tbl[-1], x2, 2 * p))
    acc = tbl[first >> 1]
    for sq, d in steps:
        for _ in range(sq):
            acc = mul(FP, acc, acc, 2 * p)
        acc = mul(FP, acc, tbl[d >> 1], 2 * p)
    out = acc - p if acc >= p else acc
    want = pow(x, p - 2, p) * R % p
    assert out == want


def test_ntt_block_size_is_the_plain_versions():
    assert int(re.search(r"NTT_LOW_MAX = (\d+);", MUL_CU).group(1)) == \
        fk.NTT_LOW_LOG


@pytest.mark.parametrize("log_n", [1, 3, 6])
def test_ntt_bound_skips_the_unit_twiddles(log_n):
    """ntt_imads counts one multiply per butterfly whose twiddle is not 1:
    each stage's first twiddle is 1 (R mod p in Montgomery form), and each
    group of a stage uses it once."""
    import chip_smoke as cs
    from bazuka_tpu_torch.fields.limbs import fr_field
    from bazuka_tpu_torch.ops import ntt as tn
    F = fr_field()
    n = 1 << log_n
    tw = F.decode(tn._stage_twiddles(log_n, False, "cpu"))
    unit = 0
    for s in range(log_n):
        h = 1 << s
        unit += n // (2 * h) * sum(int(w) == 1 for w in tw[h - 1:2 * h - 1])
    assert unit == n - 1
    assert cs.ntt_imads(n) == (n // 2 * log_n - unit) * cs.mont_mul_imads(16)


def test_inversion_bound_counts_squarings_as_squarings():
    """A squaring has s(s + 1) / 2 distinct word products: 3s^2 + 2s IMAD
    against a multiply's 4s^2 + s, for s = 12 words 456 against 588.  The
    inversion's bound is p - 2's 380 squarings and its 78 window
    multiplies; the kernel's chain does 463 products at 588."""
    import chip_smoke as cs
    s = 12
    distinct = {(i, j) for i in range(s) for j in range(s) if i <= j}
    assert cs.mont_sqr_imads(24) == 2 * len(distinct) + 2 * s * s + s == 456
    assert cs.mont_mul_imads(24) == 588
    _, steps = fk.fermat_windows(FP_MODULUS - 2)
    assert (FP_MODULUS - 2).bit_length() - 1 == 380 and len(steps) == 78
    assert cs.INV_FP_IMADS == 380 * 456 + 78 * 588 < 463 * 588
