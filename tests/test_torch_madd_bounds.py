"""The lazy-reduction schedule of kernels K2-K7 (`csrc/fp_lazy.cuh` on
`csrc/mont_ptx.cuh`, `csrc/add_select.cu`), modelled in Python ints on the
CPU.

The CUDA code cannot run here, so this file holds its arithmetic instead:
- the Fp constants of `mont_ptx.cuh` (`FpMod`) are p, 2p and -p^-1 mod
  2^32;
- a word-by-word model of its Montgomery multiply (CIOS over an even and
  a one-word-up accumulator, carry chains of 64-bit products, no final
  subtract), add, sub and canon asserts every bound the header's note
  states: each carry the code drops is 0, no add into the top word
  overflows, the accumulator stays below a + p, every operand and result
  lies in [0, 2p), every sum below 2^384;
- models of the two formulas, slot for slot in the kernels' order (G1
  over Fp, G2 over Fp2 with Karatsuba): the mixed add of K2/K4
  (`madd_formula`) and the projective add of K3/K5 and, with every lane
  active, K6/K7 (`add_formula`).  Each runs on lanes whose coordinates are
  all p - 1, all 0, alternating, and seeded random, every acc pattern
  against every Q pattern, asserting each intermediate below 2p, and its
  canonical outputs equal the plain versions of `curve_kernels` limb for
  limb, a masked-off lane of an add-select copying acc;
- every header a `csrc` file includes is in `_cuda.HEADERS` and every
  `.cu` in `_cuda.SOURCES`, so the library hash names every built file.

The model and the CUDA code must change together: a new operation or a
reordered formula in one needs the same change in the other.
"""

import re

import numpy as np
import pytest
import torch

from bazuka_tpu_torch.fields.limbs import array_to_ints, ints_to_array
from bazuka_tpu_torch.ops import _cuda
from bazuka_tpu_torch.ops import curve_kernels as ck

# One intra-op thread per test process keeps parallel test workers from
# oversubscribing the cores.
torch.set_num_threads(1)

P = int("1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241e"
        "abfffeb153ffffb9feffffffffaaab", 16)
R = 1 << 384
R_INV = pow(R, -1, P)
MASK = (1 << 32) - 1
# the body of mont_ptx.cuh's Fp modulus
HEADER = re.search(r"struct FpMod \{(.*?)\n\};",
                   (_cuda.CSRC / "mont_ptx.cuh").read_text(), re.S).group(1)


def _words(x):
    return [(x >> (32 * j)) & MASK for j in range(12)]


def _from_words(w):
    return sum(v << (32 * j) for j, v in enumerate(w))


def _header_words(fn):
    body = re.search(fn + r"\(int j\) \{.*?\{(.*?)\};", HEADER, re.S).group(1)
    return [int(v, 16) for v in re.findall(r"0x([0-9a-f]+)u", body)]


P_WORDS = _header_words("p")
P2_WORDS = _header_words("p2")
PINV = int(re.search(r"PINV = 0x([0-9a-f]+)u", HEADER).group(1), 16)


class Bound(AssertionError):
    pass


def check(cond, what):
    if not cond:
        raise Bound(what)


# ------------------------------- Fp, as fp_lazy.cuh on mont_ptx.cuh

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
    s = y[11] + c
    check(s >> 32 == 0, "addc into y_11 does not overflow")
    y[11] = s


def mul(a, b):
    """lazy::mul, word by word: accumulators x (even pairs) and y (one
    word up), t = x + 2^32 y; between steps t = o + (e >> 32), e_0 = 0."""
    check(0 <= a < 2 * P and 0 <= b < 2 * P, "mul operand below 2p")
    A, B = _words(a), _words(b)
    e, o = [0] * 12, [0] * 12
    for i in range(12):
        check(e[0] == 0, "e_0 is 0 between steps")
        t_cur = _from_words(o) + (_from_words(e) >> 32)
        check(t_cur < a + P, "t < a + p at a step's start")
        bi = B[i]
        x, y = [0] * 12, [0] * 12
        s = o[0] + e[1]  # add.cc
        x[0], c = s & MASK, s >> 32
        c = _pairs(y, c, [(j - 1, A[j], bi, (e[j + 1], e[j + 2]))
                          for j in range(1, 11, 2)])
        _pairs(y, c, [(10, A[11], bi, (0, 0))], last_cc=False)
        x[1:] = o[1:]
        _addc_top(y, _pairs(x, 0, [(j, A[j], bi, (x[j], x[j + 1]))
                                   for j in range(0, 12, 2)]))
        m = (x[0] * PINV) & MASK
        _addc_top(y, _pairs(x, 0, [(j, m, P_WORDS[j], (x[j], x[j + 1]))
                                   for j in range(0, 12, 2)]))
        check(x[0] == 0, "m zeroes x_0")
        c = _pairs(y, 0, [(j - 1, m, P_WORDS[j], (y[j - 1], y[j]))
                          for j in range(1, 11, 2)])
        _pairs(y, c, [(10, m, P_WORDS[11], (y[10], y[11]))], last_cc=False)
        e, o = x, y
    t = _from_words(o) + _from_words(e[1:] + [0])
    check(t < R, "o + (e >> 32): no carry out of word 11")
    r = t
    check(r < 2 * P, "mul result below 2p")
    assert r % P == a * b * R_INV % P
    return r


def _reduce_once(x, m):
    return x - m if x >= m else x


def add(a, b):
    check(0 <= a < 2 * P and 0 <= b < 2 * P, "add operand below 2p")
    s = a + b
    check(s < R, "add: no carry out of word 11")
    r = _reduce_once(s, 2 * P)
    check(r < 2 * P, "add result below 2p")
    return r


def sub(a, b):
    check(0 <= a < 2 * P and 0 <= b < 2 * P, "sub operand below 2p")
    d = (a - b) % R  # the borrow chain
    if a < b:
        d = (d + 2 * P) % R  # add 2p on a borrow
    check(d < 2 * P and d % P == (a - b) % P, "sub result below 2p")
    return d


def canon(x):
    check(0 <= x < 2 * P, "canon operand below 2p")
    return _reduce_once(x, P)


def mul12(x):
    x2 = add(x, x)
    x4 = add(x2, x2)
    x8 = add(x4, x4)
    return add(x8, x4)


class G1:
    """G1Lazy: a coordinate is one Fp element, as a 1-tuple."""
    NFP = 1

    @staticmethod
    def add(a, b):
        return (add(a[0], b[0]),)

    @staticmethod
    def sub(a, b):
        return (sub(a[0], b[0]),)

    @staticmethod
    def mul(a, b):
        return (mul(a[0], b[0]),)

    @staticmethod
    def mul_b3(a):
        return (mul12(a[0]),)

    @staticmethod
    def canon(a):
        return (canon(a[0]),)


class G2:
    """G2Lazy: Fp2 = Fp[u]/(u^2 + 1), Karatsuba multiply, b3 = 12 + 12u."""
    NFP = 2

    @staticmethod
    def add(a, b):
        return (add(a[0], b[0]), add(a[1], b[1]))

    @staticmethod
    def sub(a, b):
        return (sub(a[0], b[0]), sub(a[1], b[1]))

    @staticmethod
    def mul(a, b):
        t0 = mul(a[0], b[0])
        t1 = mul(a[1], b[1])
        t2 = mul(add(a[0], a[1]), add(b[0], b[1]))
        return (sub(t0, t1), sub(sub(t2, t0), t1))

    @staticmethod
    def mul_b3(a):
        return (mul12(sub(a[0], a[1])), mul12(add(a[0], a[1])))

    @staticmethod
    def canon(a):
        return tuple(canon(c) for c in a)


def madd_formula(K, acc, q):
    """`madd_formula` of add_select.cu, slot for slot: acc = (X1, Y1, Z1),
    q = (X2, Y2) -> canonical (X3, Y3, Z3)."""
    st = {"X1": acc[0], "Y1": acc[1], "Z1": acc[2], "X2": q[0], "Y2": q[1]}
    st["SPARE"] = K.mul(st["X1"], st["X2"])
    u = K.sub(K.mul(K.add(st["X1"], st["Y1"]), K.add(st["X2"], st["Y2"])),
              st["SPARE"])
    st["X1"] = K.add(st["X1"], K.mul(st["Z1"], st["X2"]))
    st["X2"] = u
    t1 = K.mul(st["Y1"], st["Y2"])
    st["X2"] = K.sub(st["X2"], t1)
    st["Y1"] = K.add(st["Y1"], K.mul(st["Z1"], st["Y2"]))
    t0 = st["SPARE"]
    st["Y2"] = K.add(K.add(t0, t0), t0)
    t2 = K.mul_b3(st["Z1"])
    st["Z1"] = K.add(t1, t2)
    st["SPARE"] = K.sub(t1, t2)
    st["X1"] = K.mul_b3(st["X1"])
    x = K.canon(K.sub(K.mul(st["X2"], st["SPARE"]),
                      K.mul(st["Y1"], st["X1"])))
    y = K.canon(K.add(K.mul(st["X1"], st["Y2"]),
                      K.mul(st["SPARE"], st["Z1"])))
    z = K.canon(K.add(K.mul(st["Z1"], st["Y1"]), K.mul(st["Y2"], st["X2"])))
    return x, y, z


def add_formula(K, acc, q):
    """`add_formula` of add_select.cu, slot for slot: acc = (X1, Y1, Z1),
    q = (X2, Y2, Z2) -> canonical (X3, Y3, Z3).  The six products take the
    input pairs in the order X, X + Y, X + Z, Y, Y + Z, Z."""
    st = {"X1": acc[0], "Y1": acc[1], "Z1": acc[2],
          "X2": q[0], "Y2": q[1], "Z2": q[2]}
    t0 = K.mul(st["X1"], st["X2"])
    u = K.sub(K.mul(K.add(st["X1"], st["Y1"]), K.add(st["X2"], st["Y2"])),
              t0)
    a = K.add(st["X1"], st["Z1"])
    st["X1"] = u                                  # t3 + t1
    b = K.add(st["X2"], st["Z2"])
    st["X2"] = t0
    v = K.sub(K.mul(a, b), st["X2"])              # Y3 + t2
    t1 = K.mul(st["Y1"], st["Y2"])
    st["X1"] = K.sub(st["X1"], t1)                # t3
    a = K.add(st["Y1"], st["Z1"])
    st["Y1"] = v
    b = K.add(st["Y2"], st["Z2"])
    st["Y2"] = t1
    w = K.sub(K.mul(a, b), st["Y2"])              # t4 + t2
    a = st["Z1"]
    st["Z1"] = w
    b = st["Z2"]
    t2 = K.mul(a, b)
    st["Y1"] = K.mul_b3(K.sub(st["Y1"], t2))      # b3 Y3
    st["Z1"] = K.sub(st["Z1"], t2)                # t4
    t2b = K.mul_b3(t2)
    t1 = st["Y2"]
    st["Y2"] = K.sub(t1, t2b)                     # t1 - b3 t2
    st["Z2"] = K.add(t1, t2b)                     # Z3
    t0 = st["X2"]
    st["X2"] = K.add(K.add(t0, t0), t0)           # X3
    x = K.canon(K.sub(K.mul(st["X1"], st["Y2"]), K.mul(st["Z1"], st["Y1"])))
    y = K.canon(K.add(K.mul(st["Y1"], st["X2"]), K.mul(st["Y2"], st["Z2"])))
    z = K.canon(K.add(K.mul(st["Z2"], st["Z1"]), K.mul(st["X2"], st["X1"])))
    return x, y, z


# ------------------------------------------------------------ the tests


def test_header_constants():
    assert _from_words(P_WORDS) == P and P.bit_length() == 381
    assert _from_words(P2_WORDS) == 2 * P
    assert (P * PINV) % (1 << 32) == (1 << 32) - 1
    assert 4 * P < R


EDGE = [0, 1, P - 1, P, P + 1, 2 * P - 1]


@pytest.mark.parametrize("op", ["mul", "add", "sub", "canon"])
def test_field_ops_hold_their_bounds(op):
    """Every pair of edge values in [0, 2p) and 40 seeded random pairs."""
    rng = np.random.default_rng(3)
    rand = [int.from_bytes(rng.bytes(48), "little") % (2 * P)
            for _ in range(80)]
    pairs = [(a, b) for a in EDGE for b in EDGE] + list(zip(rand[::2],
                                                            rand[1::2]))
    for a, b in pairs:
        if op == "mul":
            mul(a, b)
        elif op == "add":
            assert add(a, b) % P == (a + b) % P
        elif op == "sub":
            assert sub(a, b) % P == (a - b) % P
        else:
            assert canon(a) == a % P


def test_model_catches_a_missing_reduction():
    """An add that skipped its conditional subtract of 2p hands the next
    multiply an operand the schedule does not allow."""
    s = (2 * P - 1) + (2 * P - 1)
    with pytest.raises(Bound):
        mul(s, 1)
    with pytest.raises(Bound):
        sub(0, s)


def _lanes(n_coords, n_random, seed):
    """Lanes of canonical coordinates: all p - 1, all 0, alternating
    p - 1 / 0 both ways, then seeded random values below p."""
    rng = np.random.default_rng(seed)
    lanes = [[P - 1] * n_coords, [0] * n_coords,
             [P - 1 if i % 2 else 0 for i in range(n_coords)],
             [0 if i % 2 else P - 1 for i in range(n_coords)]]
    for _ in range(n_random):
        lanes.append([int.from_bytes(rng.bytes(48), "little") % P
                      for _ in range(n_coords)])
    return lanes


def _to_lm(lanes, planes):
    """Per-lane ints -> limb-major (planes, 24, L) int32."""
    arr = ints_to_array(np.array(lanes, dtype=object).T[:planes], 24)
    return torch.from_numpy(np.ascontiguousarray(
        arr.transpose(0, 2, 1)).view(np.int32))


def _from_lm(t):
    """Limb-major (planes, 24, L) int32 -> per-lane lists of ints."""
    arr = t.numpy().view(np.uint32).transpose(2, 0, 1)
    return array_to_ints(arr).tolist()


def _check_schedule(K, formula, plain, n_q, seed, select=True):
    """`formula` on the lanes of `_lanes` against `plain`: an add-select's
    plain version (acc, q, mask) with lane 1 masked off, or with `select`
    False a full add's (p, q) with every lane active."""
    nfp = K.NFP
    lanes = _lanes((3 + n_q) * nfp, 6 if nfp == 1 else 3, seed)
    # the 16 edge-value lanes: every acc pattern against every Q pattern
    # (Z2 included where Q is projective)
    edge = [a[:3 * nfp] + b[3 * nfp:] for a in lanes[:4] for b in lanes[:4]]
    lanes = edge + lanes[4:]
    acc = _to_lm([ln[:3 * nfp] for ln in lanes], 3 * nfp)
    q = _to_lm([ln[3 * nfp:] for ln in lanes], n_q * nfp)
    mask = torch.ones(len(lanes), dtype=torch.bool)
    if select:
        mask[1] = False  # a masked-off lane copies acc
        want = _from_lm(plain(acc, q, mask))
    else:
        want = _from_lm(plain(acc, q))
    for i, ln in enumerate(lanes):
        if not mask[i]:
            assert want[i] == ln[:3 * nfp]
            continue
        coords = [tuple(ln[k * nfp:(k + 1) * nfp]) for k in range(3 + n_q)]
        got = formula(K, coords[:3], coords[3:])
        assert [c for coord in got for c in coord] == want[i], i


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_madd_schedule_matches_plain(kind):
    """K2 (G1) and K4 (G2): Q affine."""
    if kind == "g1":
        _check_schedule(G1, madd_formula, ck.madd_select_lm_plain, 2, 11)
    else:
        _check_schedule(G2, madd_formula, ck.madd_select_g2_lm_plain, 2, 12)


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_add_schedule_matches_plain(kind):
    """K3 (G1) and K5 (G2): Q projective."""
    if kind == "g1":
        _check_schedule(G1, add_formula, ck.add_select_lm_plain, 3, 13)
    else:
        _check_schedule(G2, add_formula, ck.add_select_g2_lm_plain, 3, 14)


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_full_add_schedule_matches_plain(kind):
    """K6 (G1) and K7 (G2): `add_formula` with no select, every lane
    active."""
    if kind == "g1":
        _check_schedule(G1, add_formula, ck.g1_add_lm_plain, 3, 15,
                        select=False)
    else:
        _check_schedule(G2, add_formula, ck.g2_add_lm_plain, 3, 16,
                        select=False)


def _includes(path):
    return re.findall(r'#include "([^"]+)"', path.read_text())


def test_every_built_file_is_hashed():
    files = sorted(p.name for p in _cuda.CSRC.iterdir())
    assert sorted(f for f in files if f.endswith(".cu")) == sorted(
        _cuda.SOURCES)
    assert sorted(f for f in files if f.endswith(".cuh")) == sorted(
        _cuda.HEADERS)
    for name in files:
        for inc in _includes(_cuda.CSRC / name):
            assert inc in _cuda.HEADERS, (name, inc)
