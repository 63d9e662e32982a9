// Montgomery arithmetic with PTX carry chains over either BLS12-381 field,
// for one element per thread: the field core of K1 (mont_mul.cu) and,
// through fp_lazy.cuh, of K2-K7 (add_select.cu).
//
// An element is NW little-endian 32-bit words (Fr: 8, Fp: 12), in
// Montgomery form with R = 2^(32 NW): the same bits as the JAX package's
// 16-bit limbs, two to a word.  A modulus M gives NW, PINV = -p^-1 mod
// 2^32 and the words of p and 2p as constants; every index is a constant
// once the loops are unrolled, so each word folds into its instruction as
// an immediate and holds no register.
//
// mul<M>(a, b) is CIOS with no final subtract, a the multiplicand and b
// taken word by word: t < a + p at the top of every word step (so t +
// a b_i + m p < 2^32 (a + p), which must fit the NW words plus the NW of
// the accumulator one word up, whose top word takes every carry) and the
// result is below (a b + p R) / R.
//   Fp (lazy):  p < 2^381, 4p < R, operands in [0, 2p) -> [0, 2p).
//   Fr:         p < 2^255, 2p < R < 4p: no lazy headroom.  The multiplicand
//               is canonical and b below R; the result is below 2p, and one
//               conditional subtract of p (reduce_once<M, false>) makes it
//               canonical.  K1's batched multiply also takes one operand
//               below R (in either field) by making the other, canonical
//               one the multiplicand.
// add<M, TWO_P> subtracts M = 2p (TWO_P) or p from a + b when the sum is
// at least M; the sum must fit in NW words (a + b < 4p for Fp's lazy
// values, < 2p for canonical Fr).  sub<M, TWO_P> adds M back on a borrow.
// tests/test_torch_madd_bounds.py (Fp) and tests/test_torch_k1_bounds.py
// (Fr) model these word by word in Python ints: change them together.
//
// The multiply adds each 64-bit word product a_j*b_i (and m*p_j) as a
// mad.lo.cc/madc.hi.cc pair: per multiply NW*(4*NW) mad instructions and
// NW m = t0*p' products, the 4s^2 + s integer multiply-adds the roofline
// bound counts (chip_smoke.py), plus the adds that move carries.  ptxas
// issues each pair as one IMAD.WIDE.U32(.X) when the pair sits on an
// aligned register pair, hence the two accumulators of `mul`: written as
// one chain of low halves and then one of high halves it issued a
// multiply plus an IADD3.X carry per mad (1,188 SASS per Fp multiply on
// sm_90a), and as pairs over one accumulator, whose odd pairs straddle
// its even ones, 710 of which 338 were MOVs.  This one issues 324 per Fp
// multiply, 300 of them IMAD-class (kernel_ab.py's SASS count; PERF.md).
// The carry flag lives across separate asm statements; each is volatile,
// so the compiler keeps their order, and nothing between them writes it.
#pragma once

#include <cstdint>

namespace bz {
namespace ptx {

// ------------------------------------------------------------- moduli

struct FrMod {
  static constexpr int NW = 8;
  static constexpr uint32_t PINV = 0xffffffffu;  // -p^-1 mod 2^32
  __host__ __device__ static __forceinline__ constexpr uint32_t p(int j) {
    constexpr uint32_t w[NW] = {
        0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
        0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
    return w[j];
  }
};

struct FpMod {
  static constexpr int NW = 12;
  static constexpr uint32_t PINV = 0xfffcfffdu;  // -p^-1 mod 2^32
  __host__ __device__ static __forceinline__ constexpr uint32_t p(int j) {
    constexpr uint32_t w[NW] = {
        0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
        0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
        0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
    return w[j];
  }
  __host__ __device__ static __forceinline__ constexpr uint32_t p2(int j) {
    constexpr uint32_t w[NW] = {
        0xffff5556u, 0x73fdffffu, 0x62a7ffffu, 0x3d57fffdu,
        0xed61ec48u, 0xce61a541u, 0xe70a257eu, 0xc8ee9709u,
        0x869759aeu, 0x96374f6cu, 0x72ffcd34u, 0x340223d4u};
    return w[j];
  }
};

template <class M>
struct Elem {
  uint32_t w[M::NW];
};

// ---------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
// (hi:lo) += a*b as one 64-bit product: a pair of chained multiply-adds
// on the same operands, which ptxas issues as one wide multiply-add with
// carry (IMAD.WIDE.U32.X).  mad_wide_cc starts a carry chain,
// madc_wide_cc continues it, madc_wide ends it (no carry out of hi);
// madc_wide_cc_to writes a*b + (chi:clo) to other registers.
__device__ __forceinline__ void mad_wide_cc(uint32_t& lo, uint32_t& hi,
                                            uint32_t a, uint32_t b) {
  asm volatile("mad.lo.cc.u32 %0, %2, %3, %0;\n\t"
               "madc.hi.cc.u32 %1, %2, %3, %1;"
               : "+r"(lo), "+r"(hi) : "r"(a), "r"(b));
}
__device__ __forceinline__ void madc_wide_cc(uint32_t& lo, uint32_t& hi,
                                             uint32_t a, uint32_t b) {
  asm volatile("madc.lo.cc.u32 %0, %2, %3, %0;\n\t"
               "madc.hi.cc.u32 %1, %2, %3, %1;"
               : "+r"(lo), "+r"(hi) : "r"(a), "r"(b));
}
__device__ __forceinline__ void madc_wide(uint32_t& lo, uint32_t& hi,
                                          uint32_t a, uint32_t b) {
  asm volatile("madc.lo.cc.u32 %0, %2, %3, %0;\n\t"
               "madc.hi.u32 %1, %2, %3, %1;"
               : "+r"(lo), "+r"(hi) : "r"(a), "r"(b));
}
__device__ __forceinline__ void madc_wide_cc_to(uint32_t& lo, uint32_t& hi,
                                                uint32_t a, uint32_t b,
                                                uint32_t clo, uint32_t chi) {
  asm volatile("madc.lo.cc.u32 %0, %2, %3, %4;\n\t"
               "madc.hi.cc.u32 %1, %2, %3, %5;"
               : "=r"(lo), "=r"(hi) : "r"(a), "r"(b), "r"(clo), "r"(chi));
}
__device__ __forceinline__ void madc_wide_to(uint32_t& lo, uint32_t& hi,
                                             uint32_t a, uint32_t b) {
  asm volatile("madc.lo.cc.u32 %0, %2, %3, 0;\n\t"
               "madc.hi.u32 %1, %2, %3, 0;"
               : "=r"(lo), "=r"(hi) : "r"(a), "r"(b));
}

// ------------------------------------------------------------ the ops

// a*b*2^(-32 NW) mod p, below (a b + p R) / R; no final subtract.
//
// CIOS over two accumulators so that every 64-bit word product lands on
// an aligned register pair: x holds words at even offsets (0, 1), (2, 3),
// ... and y the same one word up, so t = x + 2^32 y.  Products a_j*b_i
// with even j go to x, odd j to y; likewise m*p_j.  After the reduction
// x_0 = 0 and t / 2^32 = y + (x >> 32): the next step takes o = y as its
// new x (plus x_1, carried into y_0) and shifts x down two words into
// its new y inside the same multiply-adds.
template <class M>
__device__ __forceinline__ Elem<M> mul(const Elem<M>& a, const Elem<M>& b) {
  constexpr int NW = M::NW;
  static_assert(NW % 2 == 0 && NW >= 4, "an even word count");
  // between steps t = o + (e >> 32), e_0 = 0
  uint32_t e[NW], o[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) e[k] = o[k] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t bi = b.w[i];
    uint32_t x[NW], y[NW];
    // x = o + e_1 + sum_{j even} a_j b_i 2^(32j),
    // y = (e >> 64) + sum_{j odd} a_j b_i 2^(32(j-1)); the carry of
    // o_0 + e_1 enters y_0, the carry out of x's top word enters y's
    x[0] = add_cc(o[0], e[1]);
#pragma unroll
    for (int j = 1; j < NW - 1; j += 2)
      madc_wide_cc_to(y[j - 1], y[j], a.w[j], bi, e[j + 1], e[j + 2]);
    madc_wide_to(y[NW - 2], y[NW - 1], a.w[NW - 1], bi);
#pragma unroll
    for (int k = 1; k < NW; ++k) x[k] = o[k];
    mad_wide_cc(x[0], x[1], a.w[0], bi);
#pragma unroll
    for (int j = 2; j < NW; j += 2) madc_wide_cc(x[j], x[j + 1], a.w[j], bi);
    y[NW - 1] = addc(y[NW - 1], 0);
    // t += m p with m = t_0 p' mod 2^32, which zeroes x_0
    const uint32_t m = x[0] * M::PINV;
    mad_wide_cc(x[0], x[1], m, M::p(0));
#pragma unroll
    for (int j = 2; j < NW; j += 2) madc_wide_cc(x[j], x[j + 1], m, M::p(j));
    y[NW - 1] = addc(y[NW - 1], 0);
    mad_wide_cc(y[0], y[1], m, M::p(1));
#pragma unroll
    for (int j = 3; j < NW - 1; j += 2)
      madc_wide_cc(y[j - 1], y[j], m, M::p(j));
    madc_wide(y[NW - 2], y[NW - 1], m, M::p(NW - 1));
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      e[k] = x[k];
      o[k] = y[k];
    }
  }
  // o + (e >> 32): the sum is below R, so nothing carries out of the top
  Elem<M> r;
  r.w[0] = add_cc(o[0], e[1]);
#pragma unroll
  for (int k = 1; k < NW - 1; ++k) r.w[k] = addc_cc(o[k], e[k + 1]);
  r.w[NW - 1] = addc(o[NW - 1], 0);
  return r;
}

template <class M, bool TWO_P>
__device__ __forceinline__ constexpr uint32_t mod_word(int j) {
  if constexpr (TWO_P) {
    return M::p2(j);
  } else {
    return M::p(j);
  }
}

// x - m if x >= m, else x, for m = 2p (TWO_P) or p
template <class M, bool TWO_P>
__device__ __forceinline__ Elem<M> reduce_once(const Elem<M>& x) {
  constexpr int NW = M::NW;
  Elem<M> d;
  d.w[0] = sub_cc(x.w[0], mod_word<M, TWO_P>(0));
#pragma unroll
  for (int j = 1; j < NW; ++j) d.w[j] = subc_cc(x.w[j], mod_word<M, TWO_P>(j));
  const uint32_t keep = subc(0, 0);  // all ones iff x < m
  Elem<M> r;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.w[j] = (x.w[j] & keep) | (d.w[j] & ~keep);
  return r;
}

// a + b, reduced once by m = 2p (TWO_P) or p; a + b must fit in NW words
template <class M, bool TWO_P>
__device__ __forceinline__ Elem<M> add(const Elem<M>& a, const Elem<M>& b) {
  constexpr int NW = M::NW;
  Elem<M> s;
  s.w[0] = add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int j = 1; j < NW - 1; ++j) s.w[j] = addc_cc(a.w[j], b.w[j]);
  s.w[NW - 1] = addc(a.w[NW - 1], b.w[NW - 1]);
  return reduce_once<M, TWO_P>(s);
}

// a - b, plus m = 2p (TWO_P) or p on a borrow
template <class M, bool TWO_P>
__device__ __forceinline__ Elem<M> sub(const Elem<M>& a, const Elem<M>& b) {
  constexpr int NW = M::NW;
  Elem<M> d;
  d.w[0] = sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int j = 1; j < NW; ++j) d.w[j] = subc_cc(a.w[j], b.w[j]);
  const uint32_t borrow = subc(0, 0);  // all ones iff a < b
  uint32_t m[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) m[j] = mod_word<M, TWO_P>(j) & borrow;
  Elem<M> r;
  r.w[0] = add_cc(d.w[0], m[0]);
#pragma unroll
  for (int j = 1; j < NW - 1; ++j) r.w[j] = addc_cc(d.w[j], m[j]);
  r.w[NW - 1] = addc(d.w[NW - 1], m[NW - 1]);
  return r;
}

}  // namespace ptx
}  // namespace bz
