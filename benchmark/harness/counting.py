"""What a kernel launch needs at the least, counted from its sizes: the
bytes it must move and the 32-bit integer multiply-adds (IMADs) its lanes
must do, and the time the card's peaks allow for them.  Copied from
`chip_smoke.py` (its bound arithmetic and kernel replay) so that the
yardstick stays fixed while the program changes.

A launch's bound is the larger of its bytes over the HBM rate and its
IMADs over the IMAD rate.  The counts are of the work the inputs need,
not of what an implementation does: each input byte read once and each
output byte written once, one CIOS Montgomery multiply per field product,
and in the curve adds K2-K5 the formula only in the lanes whose select is
on (the others copy their accumulator).
"""

from __future__ import annotations

# H100 SXM peaks: HBM3 bytes/s (NVIDIA data sheet), and 32-bit integer
# multiply-adds/s = 132 SMs x 64 IMAD per SM per clock (CUDA C++
# Programming Guide, arithmetic throughput, compute capability 9.0) x the
# 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 132 * 64 * 1.98e9

FR_LIMBS, FP_LIMBS = 16, 24  # 16-bit limbs of an Fr and an Fp element
LIMB_BYTES = 4  # each limb is held in an int32
FP_MODULUS = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB


def mont_mul_imads(n_limbs: int) -> int:
    """IMADs of one CIOS Montgomery multiply over s = n/2 words: s^2 word
    products and s^2 + s reduction products, each word product a low and
    a high IMAD, the m = t0 * p' products one IMAD."""
    s = n_limbs // 2
    return 2 * s * s + 2 * s * s + s


def mont_sqr_imads(n_limbs: int) -> int:
    """The same for a squaring: s(s + 1) / 2 distinct word products (the
    doubled cross products are shifts and adds), then the reduction."""
    s = n_limbs // 2
    return s * (s + 1) + 2 * s * s + s


def ntt_imads(n: int, m: int = 0) -> int:
    """IMADs of the radix-2 stages of NTTs over Fr of rows of m (0: one
    row of n) of n elements: one multiply per butterfly, less those whose
    twiddle is 1 (the first of each group, m - 1 a row)."""
    m = m or n
    return n // m * (m // 2 * (m.bit_length() - 1) - (m - 1)) * \
        mont_mul_imads(FR_LIMBS)


def sliding_windows(e: int, width: int = 4) -> int:
    """Multiplies by a table entry in the sliding-window chain of x^e from
    its top bit, windows of at most `width` bits (the first is the
    chain's start and not counted)."""
    bits = bin(e)[2:]
    count, i = 0, 0
    while i < len(bits):
        if bits[i] == "0":
            i += 1
            continue
        j = min(i + width, len(bits))
        while bits[j - 1] == "0":
            j -= 1
        count += 1
        i = j
    return count - 1


# IMADs of z^(p - 2) over Fp per element, at the least: a squaring per
# bit of p - 2 but the top one, one multiply per sliding 4-bit window
# (the windows' table of odd powers is not counted)
INV_FP_IMADS = ((FP_MODULUS - 2).bit_length() - 1) * mont_sqr_imads(
    FP_LIMBS) + sliding_windows(FP_MODULUS - 2) * mont_mul_imads(FP_LIMBS)

# the curve adds: (projective planes of acc, planes of Q, Fp multiplies per
# active lane); G2 planes are two Fp planes per coordinate
CURVE = {
    "g1_madd_select": (3, 2, 11),
    "g1_add_select": (3, 3, 12),
    "g2_madd_select": (6, 4, 33),
    "g2_add_select": (6, 6, 36),
}


def bound_s(nbytes: float, imads: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, imads / IMAD_PER_S)


def k1_mul(n_limbs: int, n: int, b_rows: int) -> float:
    """K1's multiply of n elements against b_rows rows of b."""
    return bound_s((2 * n + b_rows) * n_limbs * LIMB_BYTES,
                   n * mont_mul_imads(n_limbs))


def ntt_stages(n: int, row: int) -> float:
    m = row or n
    return bound_s((2 * n + m - 1) * FR_LIMBS * LIMB_BYTES, ntt_imads(n, m))


def inversion(n: int) -> float:
    return bound_s(2 * n * FP_LIMBS * LIMB_BYTES, n * INV_FP_IMADS)


def curve_add(kernel: str, lanes: int, active: int) -> float:
    """acc read and the result written in every lane, Q read and the
    formula run where the select is on."""
    acc_planes, q_planes, n_mul = CURVE[kernel]
    nbytes = (lanes * (2 * acc_planes * FP_LIMBS * LIMB_BYTES + 1)
              + active * q_planes * FP_LIMBS * LIMB_BYTES)
    return bound_s(nbytes, active * n_mul * mont_mul_imads(FP_LIMBS))


def launch_bound_s(kernel: str, n: int, extra: int) -> float:
    """The bound of one launch of a proof's kernel, by its registry name
    and its (n, extra) sizes; the curve adds by (lanes, active lanes)."""
    if kernel == "mont_mul_fr":
        return k1_mul(FR_LIMBS, n, extra)
    if kernel == "mont_mul_fp":
        return k1_mul(FP_LIMBS, n, extra)
    if kernel == "ntt_stages_fr":
        return ntt_stages(n, extra)
    if kernel == "mont_inv_fp":
        return inversion(n)
    return curve_add(kernel, n, extra)
