"""BLS12-381 curves and the optimal-ate pairing (host ground truth).

G1: y^2 = x^3 + 4        over Fp
G2: y^2 = x^3 + 4(u+1)   over Fp2   (M-type twist; untwist (x,y) ->
                                     (x/w^2, y/w^3) into E(Fp12))

The pairing drives the Groth16 *verify* path only (3 pairings per proof,
reference: src/zk/groth16/mod.rs:67-121) — low arithmetic intensity, kept
host-side per SURVEY.md §7 "hard parts" #5.  This module is the oracle of
the port's curve kernels (`ops.curve_kernels`).

A copy of `bazuka_tpu/crypto/bls12_381.py`: the port imports nothing of the
JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..fields.host import FP_MODULUS, FR_MODULUS
from ..fields import tower as tw

P = FP_MODULUS
R = FR_MODULUS  # subgroup order

B1 = 4
B2 = tw.fp2_scalar(tw.XI, 4)  # 4(u+1)

# BLS parameter x: the Miller-loop length (negative)
BLS_X = -0xD201000000010000

# standard generators
G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)

# Points are affine (x, y) or None for infinity.
G1Point = Optional[Tuple[int, int]]
G2Point = Optional[Tuple[Tuple[int, int], Tuple[int, int]]]


# ---------------------------------------------------------------- G1


def g1_is_on_curve(p: G1Point) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - x * x % P * x) % P == B1


def g1_neg(p: G1Point) -> G1Point:
    return None if p is None else (p[0], (-p[1]) % P)


def g1_add(p: G1Point, q: G1Point) -> G1Point:
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = 3 * x1 * x1 % P * pow(2 * y1 % P, -1, P) % P
    else:
        lam = (y2 - y1) * pow((x2 - x1) % P, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def g1_double(p: G1Point) -> G1Point:
    return g1_add(p, p)


def g1_mul(p: G1Point, k: int) -> G1Point:
    k %= R
    result = None
    addend = p
    while k:
        if k & 1:
            result = g1_add(result, addend)
        addend = g1_add(addend, addend)
        k >>= 1
    return result


def _mul_nored(add, p, k: int):
    """Double-and-add WITHOUT reducing k mod R — needed for subgroup
    checks, where g1_mul's `k %= R` would turn [R]P into [0]P = identity
    for every point."""
    result = None
    addend = p
    while k:
        if k & 1:
            result = add(result, addend)
        addend = add(addend, addend)
        k >>= 1
    return result


def g1_in_subgroup(p: G1Point) -> bool:
    """Prime-order-subgroup membership: [R]P == identity.  G1's cofactor
    is ~2^125, so on-curve does not imply order R (bellman checks this at
    deserialization; untrusted wire points must too)."""
    return p is None or _mul_nored(g1_add, p, R) is None


# ---------------------------------------------------------------- G2


def g2_is_on_curve(p: G2Point) -> bool:
    if p is None:
        return True
    x, y = p
    lhs = tw.fp2_sub(tw.fp2_sqr(y), tw.fp2_mul(tw.fp2_sqr(x), x))
    return lhs == B2


def g2_neg(p: G2Point) -> G2Point:
    return None if p is None else (p[0], tw.fp2_neg(p[1]))


def g2_add(p: G2Point, q: G2Point) -> G2Point:
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if tw.fp2_add(y1, y2) == tw.FP2_ZERO:
            return None
        num = tw.fp2_scalar(tw.fp2_sqr(x1), 3)
        den = tw.fp2_scalar(y1, 2)
    else:
        num = tw.fp2_sub(y2, y1)
        den = tw.fp2_sub(x2, x1)
    lam = tw.fp2_mul(num, tw.fp2_inv(den))
    x3 = tw.fp2_sub(tw.fp2_sub(tw.fp2_sqr(lam), x1), x2)
    y3 = tw.fp2_sub(tw.fp2_mul(lam, tw.fp2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_mul(p: G2Point, k: int) -> G2Point:
    k %= R
    result = None
    addend = p
    while k:
        if k & 1:
            result = g2_add(result, addend)
        addend = g2_add(addend, addend)
        k >>= 1
    return result


def g2_in_subgroup(p: G2Point) -> bool:
    """[R]P == identity over G2 (cofactor ~2^250)."""
    return p is None or _mul_nored(g2_add, p, R) is None


# ---------------------------------------------------------------- pairing

# Untwist constants: 1/w^2 and 1/w^3 in Fp12
_W2_INV = tw.fp12_inv(tw.W2)
_W3_INV = tw.fp12_inv(tw.W3)


def _untwist(q: G2Point):
    """E'(Fp2) -> E(Fp12): (x, y) -> (x/w^2, y/w^3)."""
    x = tw.fp12_mul(tw.fp2_to_fp12(q[0]), _W2_INV)
    y = tw.fp12_mul(tw.fp2_to_fp12(q[1]), _W3_INV)
    return (x, y)


def _line(p1, p2, t):
    """Line through p1, p2 (E(Fp12) affine points) evaluated at t."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        num = tw.fp12_sub(y2, y1)
        den = tw.fp12_sub(x2, x1)
    elif y1 == y2:
        num = fp12_scalar3(tw.fp12_mul(x1, x1))
        den = tw.fp12_add(y1, y1)
    else:
        return tw.fp12_sub(xt, x1)
    lam = tw.fp12_mul(num, tw.fp12_inv(den))
    return tw.fp12_sub(
        tw.fp12_mul(lam, tw.fp12_sub(xt, x1)), tw.fp12_sub(yt, y1)
    )


def fp12_scalar3(a):
    return tw.fp12_add(tw.fp12_add(a, a), a)


def _ec12_add(p, q):
    """Affine add on E(Fp12) (same Weierstrass law, b irrelevant here)."""
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if tw.fp12_add(y1, y2) == tw.FP12_ZERO:
            return None
        num = tw.fp12_mul(tw.fp12_mul(x1, x1), fp12_scalar3(tw.FP12_ONE))
        den = tw.fp12_add(y1, y1)
    else:
        num = tw.fp12_sub(y2, y1)
        den = tw.fp12_sub(x2, x1)
    lam = tw.fp12_mul(num, tw.fp12_inv(den))
    x3 = tw.fp12_sub(tw.fp12_sub(tw.fp12_mul(lam, lam), x1), x2)
    y3 = tw.fp12_sub(tw.fp12_mul(lam, tw.fp12_sub(x1, x3)), y1)
    return (x3, y3)


def miller_loop(q: G2Point, p: G1Point):
    """f_{|x|, Q}(P) with the standard double-and-add over |BLS_X| bits,
    conjugated at the end because BLS_X < 0."""
    if p is None or q is None:
        return tw.FP12_ONE
    qq = _untwist(q)
    pp = (tw.fp_to_fp12(p[0]), tw.fp_to_fp12(p[1]))
    n = -BLS_X
    f = tw.FP12_ONE
    t = qq
    for i in range(n.bit_length() - 2, -1, -1):
        f = tw.fp12_mul(tw.fp12_sqr(f), _line(t, t, pp))
        t = _ec12_add(t, t)
        if (n >> i) & 1:
            f = tw.fp12_mul(f, _line(t, qq, pp))
            t = _ec12_add(t, qq)
    # x < 0: conjugate
    return tw.fp12_conj(f)


_FINAL_EXP_HARD = (P**4 - P**2 + 1) // R


def final_exponentiation(f):
    """f^((p^12-1)/r): easy part (p^6-1)(p^2+1) then hard part exponent."""
    # easy: f = conj(f) * f^-1, then f = f^(p^2) * f
    f = tw.fp12_mul(tw.fp12_conj(f), tw.fp12_inv(f))
    f = tw.fp12_mul(tw.fp12_pow(f, P * P), f)
    return tw.fp12_pow(f, _FINAL_EXP_HARD)


def pairing(q: G2Point, p: G1Point):
    """e(P, Q) into the r-th roots of unity of Fp12."""
    return final_exponentiation(miller_loop(q, p))


def multi_pairing(pairs):
    """prod e(P_i, Q_i) with a single final exponentiation."""
    f = tw.FP12_ONE
    for p, q in pairs:
        f = tw.fp12_mul(f, miller_loop(q, p))
    return final_exponentiation(f)
