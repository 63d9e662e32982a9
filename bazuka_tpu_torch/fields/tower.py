"""BLS12-381 extension-field tower (host ground truth, Python ints).

Fp2  = Fp[u]  / (u^2 + 1)
Fp6  = Fp2[v] / (v^3 - xi),  xi = u + 1
Fp12 = Fp6[w] / (w^2 - v)

Representations: Fp2 = (c0, c1); Fp6 = (a0, a1, a2) of Fp2; Fp12 = (b0, b1)
of Fp6.  Used by the host pairing (`crypto.bls12_381`) — the Groth16
*verify* path — and as the bit-exactness oracle for the Fp2/G2 kernels.
A copy of `bazuka_tpu/fields/tower.py`.
The reference gets all of this from the `bls12_381` crate
(reference: src/zk/groth16/mod.rs:4, SURVEY.md §2.2).
"""

from __future__ import annotations

from .host import FP_MODULUS

P = FP_MODULUS

# ---------------------------------------------------------------- Fp2

FP2_ZERO = (0, 0)
FP2_ONE = (1, 0)
XI = (1, 1)  # u + 1


def fp2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fp2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fp2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def fp2_mul(a, b):
    # Karatsuba: (a0 b0 - a1 b1) + ((a0+a1)(b0+b1) - a0b0 - a1b1) u
    t0 = a[0] * b[0] % P
    t1 = a[1] * b[1] % P
    t2 = (a[0] + a[1]) * (b[0] + b[1]) % P
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def fp2_sqr(a):
    # (a0+a1)(a0-a1) + 2 a0 a1 u
    t0 = (a[0] + a[1]) * (a[0] - a[1]) % P
    t1 = 2 * a[0] * a[1] % P
    return (t0, t1)


def fp2_scalar(a, k: int):
    return (a[0] * k % P, a[1] * k % P)


def fp2_inv(a):
    d = (a[0] * a[0] + a[1] * a[1]) % P
    di = pow(d, -1, P)
    return (a[0] * di % P, (-a[1]) * di % P)


def fp2_mul_xi(a):
    # (c0 + c1 u)(1 + u) = (c0 - c1) + (c0 + c1) u
    return ((a[0] - a[1]) % P, (a[0] + a[1]) % P)


# ---------------------------------------------------------------- Fp6

FP6_ZERO = (FP2_ZERO, FP2_ZERO, FP2_ZERO)
FP6_ONE = (FP2_ONE, FP2_ZERO, FP2_ZERO)


def fp6_add(a, b):
    return tuple(fp2_add(x, y) for x, y in zip(a, b))


def fp6_sub(a, b):
    return tuple(fp2_sub(x, y) for x, y in zip(a, b))


def fp6_neg(a):
    return tuple(fp2_neg(x) for x in a)


def fp6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fp2_mul(a0, b0)
    t1 = fp2_mul(a1, b1)
    t2 = fp2_mul(a2, b2)
    c0 = fp2_add(
        t0,
        fp2_mul_xi(
            fp2_sub(fp2_sub(fp2_mul(fp2_add(a1, a2), fp2_add(b1, b2)), t1), t2)
        ),
    )
    c1 = fp2_add(
        fp2_sub(fp2_sub(fp2_mul(fp2_add(a0, a1), fp2_add(b0, b1)), t0), t1),
        fp2_mul_xi(t2),
    )
    c2 = fp2_add(
        fp2_sub(fp2_sub(fp2_mul(fp2_add(a0, a2), fp2_add(b0, b2)), t0), t2), t1
    )
    return (c0, c1, c2)


def fp6_sqr(a):
    return fp6_mul(a, a)


def fp6_mul_v(a):
    """Multiply by v: (a0, a1, a2) -> (xi*a2, a0, a1)."""
    return (fp2_mul_xi(a[2]), a[0], a[1])


def fp6_inv(a):
    a0, a1, a2 = a
    c0 = fp2_sub(fp2_sqr(a0), fp2_mul_xi(fp2_mul(a1, a2)))
    c1 = fp2_sub(fp2_mul_xi(fp2_sqr(a2)), fp2_mul(a0, a1))
    c2 = fp2_sub(fp2_sqr(a1), fp2_mul(a0, a2))
    t = fp2_add(
        fp2_add(fp2_mul(a0, c0), fp2_mul_xi(fp2_mul(a2, c1))),
        fp2_mul_xi(fp2_mul(a1, c2)),
    )
    ti = fp2_inv(t)
    return (fp2_mul(c0, ti), fp2_mul(c1, ti), fp2_mul(c2, ti))


# ---------------------------------------------------------------- Fp12

FP12_ZERO = (FP6_ZERO, FP6_ZERO)
FP12_ONE = (FP6_ONE, FP6_ZERO)


def fp12_add(a, b):
    return (fp6_add(a[0], b[0]), fp6_add(a[1], b[1]))


def fp12_sub(a, b):
    return (fp6_sub(a[0], b[0]), fp6_sub(a[1], b[1]))


def fp12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = fp6_mul(a0, b0)
    t1 = fp6_mul(a1, b1)
    c0 = fp6_add(t0, fp6_mul_v(t1))
    c1 = fp6_sub(fp6_sub(fp6_mul(fp6_add(a0, a1), fp6_add(b0, b1)), t0), t1)
    return (c0, c1)


def fp12_sqr(a):
    return fp12_mul(a, a)


def fp12_conj(a):
    """a^(p^6): w -> -w."""
    return (a[0], fp6_neg(a[1]))


def fp12_inv(a):
    a0, a1 = a
    t = fp6_sub(fp6_sqr(a0), fp6_mul_v(fp6_sqr(a1)))
    ti = fp6_inv(t)
    return (fp6_mul(a0, ti), fp6_neg(fp6_mul(a1, ti)))


def fp12_pow(a, e: int):
    if e < 0:
        return fp12_pow(fp12_inv(a), -e)
    r = FP12_ONE
    while e:
        if e & 1:
            r = fp12_mul(r, a)
        a = fp12_sqr(a)
        e >>= 1
    return r


def fp_to_fp12(x: int):
    return (((x % P, 0), FP2_ZERO, FP2_ZERO), FP6_ZERO)


def fp2_to_fp12(x):
    return ((x, FP2_ZERO, FP2_ZERO), FP6_ZERO)


# w as an Fp12 element, and its powers used by the untwist map
W = (FP6_ZERO, FP6_ONE)  # w = 0 + 1*w  where the Fp6 "1" sits in degree 0
W2 = (  # w^2 = v
    (FP2_ZERO, FP2_ONE, FP2_ZERO),
    FP6_ZERO,
)
W3 = (  # w^3 = v*w
    FP6_ZERO,
    (FP2_ZERO, FP2_ONE, FP2_ZERO),
)
