// BLS12-381 Fp arithmetic with PTX carry chains and lazy reduction, for
// one element per thread.  Used by add_select.cu (kernels K2-K5); K1, K6
// and K7 keep mont.cuh's fully reduced arithmetic.
//
// Elements are 12 little-endian 32-bit words, in Montgomery form with
// R = 2^384 (the same bits as the JAX package's 24 16-bit limbs).
//
// The reduction schedule.  p < 2^381, so 4p < 2^383 < R and every value
// below is held in [0, 2p) ("lazy"), not in [0, p):
//   mul    a, b in [0, 2p) -> [0, 2p).  CIOS with no final subtract: the
//          result is below (ab + pR)/R < (4p^2 + pR)/R < 2p since 4p < R.
//          Inside the loop t < a + p < 3p < 2^383 at the top of every word
//          step, so t + a*b_i + m*p < 2^416: 12 words plus the 12 of the
//          accumulator one word up, whose top word takes every carry.
//   add    a + b < 4p < 2^384 (no carry out of word 11), then subtract 2p
//          if the sum is >= 2p.
//   sub    a - b, then add 2p on a borrow: (-2p, 2p) -> [0, 2p).
//   canon  [0, 2p) -> [0, p): one conditional subtract of p.  Applied to
//          each output coordinate before its store, so the kernels' outputs
//          stay canonical and equal, limb for limb, to the plain versions.
// Fp2 (Karatsuba) and the b3 = 12 shift-add chain are built from these
// four, so their intermediates keep the same [0, 2p) bound; nothing wider
// is formed.  tests/test_torch_madd_bounds.py models this schedule word by
// word in Python ints and asserts each bound: change the two together.
//
// The multiply adds each 64-bit word product a_j*b_i (and m*p_j) as a
// mad.lo.cc/madc.hi.cc pair: per multiply 12*(4*12) = 576 mad instructions
// and 12 m = t0*p' products, the 4s^2 + s = 588 integer multiply-adds the
// roofline bound counts (chip_smoke.py), plus 12 + 24 adds that move
// carries.  ptxas issues each pair as one IMAD.WIDE.U32(.X) when the pair
// sits on an aligned register pair, hence the two accumulators of `mul`:
// written as one chain of low halves and then one of high halves it
// issued a multiply plus an IADD3.X carry per mad (1,188 SASS per
// multiply on sm_90a), and as pairs over one accumulator, whose odd pairs
// straddle its even ones, 710 of which 338 were MOVs.  This one issues
// 324, 300 of them IMAD-class (kernel_ab.py's SASS count; PERF.md).  The
// carry flag lives across separate asm statements; each is volatile, so
// the compiler keeps their order, and nothing between them writes it.
#pragma once

#include <cstdint>

namespace bz {
namespace lazy {

constexpr int NW = 12;
constexpr uint32_t PINV = 0xfffcfffdu;  // -p^-1 mod 2^32

// Words of p and 2p, little-endian.  Every index is a constant once the
// loops are unrolled, so each word folds into its instruction as an
// immediate and holds no register.
__host__ __device__ __forceinline__ constexpr uint32_t p_word(int j) {
  constexpr uint32_t w[NW] = {
      0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
      0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
      0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
  return w[j];
}
__host__ __device__ __forceinline__ constexpr uint32_t p2_word(int j) {
  constexpr uint32_t w[NW] = {
      0xffff5556u, 0x73fdffffu, 0x62a7ffffu, 0x3d57fffdu,
      0xed61ec48u, 0xce61a541u, 0xe70a257eu, 0xc8ee9709u,
      0x869759aeu, 0x96374f6cu, 0x72ffcd34u, 0x340223d4u};
  return w[j];
}

struct Fp {
  uint32_t w[NW];
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

// ------------------------------------------------------------ Fp, lazy

// a*b*2^-384 mod p: a, b in [0, 2p) -> [0, 2p).
//
// CIOS over two accumulators so that every 64-bit word product lands on
// an aligned register pair: x holds words at even offsets (0, 1), (2, 3),
// ... and y the same one word up, so t = x + 2^32 y.  Products a_j*b_i
// with even j go to x, odd j to y; likewise m*p_j.  After the reduction
// x_0 = 0 and t / 2^32 = y + (x >> 32): the next step takes o = y as its
// new x (plus x_1, carried into y_0) and shifts x down two words into
// its new y inside the same multiply-adds.
__device__ __forceinline__ Fp mul(const Fp& a, const Fp& b) {
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
    // o_0 + e_1 enters y_0, the carry out of x_11 enters y_11
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
    const uint32_t m = x[0] * PINV;
    mad_wide_cc(x[0], x[1], m, p_word(0));
#pragma unroll
    for (int j = 2; j < NW; j += 2)
      madc_wide_cc(x[j], x[j + 1], m, p_word(j));
    y[NW - 1] = addc(y[NW - 1], 0);
    mad_wide_cc(y[0], y[1], m, p_word(1));
#pragma unroll
    for (int j = 3; j < NW - 1; j += 2)
      madc_wide_cc(y[j - 1], y[j], m, p_word(j));
    madc_wide(y[NW - 2], y[NW - 1], m, p_word(NW - 1));
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      e[k] = x[k];
      o[k] = y[k];
    }
  }
  // o + (e >> 32): the sum is below 2p, so nothing carries out of word 11
  Fp r;
  r.w[0] = add_cc(o[0], e[1]);
#pragma unroll
  for (int k = 1; k < NW - 1; ++k) r.w[k] = addc_cc(o[k], e[k + 1]);
  r.w[NW - 1] = addc(o[NW - 1], 0);
  return r;
}

// x - M if x >= M, else x, for M = 2p (TWO_P) or p
template <bool TWO_P>
__device__ __forceinline__ Fp reduce_once(const Fp& x) {
  Fp d;
  d.w[0] = sub_cc(x.w[0], TWO_P ? p2_word(0) : p_word(0));
#pragma unroll
  for (int j = 1; j < NW; ++j)
    d.w[j] = subc_cc(x.w[j], TWO_P ? p2_word(j) : p_word(j));
  const uint32_t keep = subc(0, 0);  // all ones iff x < M
  Fp r;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.w[j] = (x.w[j] & keep) | (d.w[j] & ~keep);
  return r;
}

// a + b: [0, 2p) x [0, 2p) -> [0, 2p)
__device__ __forceinline__ Fp add(const Fp& a, const Fp& b) {
  Fp s;
  s.w[0] = add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int j = 1; j < NW - 1; ++j) s.w[j] = addc_cc(a.w[j], b.w[j]);
  s.w[NW - 1] = addc(a.w[NW - 1], b.w[NW - 1]);
  return reduce_once<true>(s);
}

// a - b: [0, 2p) x [0, 2p) -> [0, 2p)
__device__ __forceinline__ Fp sub(const Fp& a, const Fp& b) {
  Fp d;
  d.w[0] = sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int j = 1; j < NW; ++j) d.w[j] = subc_cc(a.w[j], b.w[j]);
  const uint32_t borrow = subc(0, 0);  // all ones iff a < b
  uint32_t m[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) m[j] = p2_word(j) & borrow;
  Fp r;
  r.w[0] = add_cc(d.w[0], m[0]);
#pragma unroll
  for (int j = 1; j < NW - 1; ++j) r.w[j] = addc_cc(d.w[j], m[j]);
  r.w[NW - 1] = addc(d.w[NW - 1], m[NW - 1]);
  return r;
}

// [0, 2p) -> [0, p)
__device__ __forceinline__ Fp canon(const Fp& x) { return reduce_once<false>(x); }

// 12x as x2 = x + x, x4, x8, x8 + x4: four lazy adds
__device__ __forceinline__ Fp mul12(const Fp& x) {
  const Fp x2 = add(x, x);
  const Fp x4 = add(x2, x2);
  const Fp x8 = add(x4, x4);
  return add(x8, x4);
}

// ------------------------------------------- curve coordinate fields

// A coordinate is NFP Fp elements: G1 over Fp, G2 over Fp2 = Fp[u]/(u^2+1)
// with b3 = 3b = 12 (G1) and 12 + 12u (G2).
struct G1Lazy {
  static constexpr int NFP = 1;
  struct E {
    Fp c[1];
  };
  __device__ static __forceinline__ E add(const E& a, const E& b) {
    return E{{lazy::add(a.c[0], b.c[0])}};
  }
  __device__ static __forceinline__ E sub(const E& a, const E& b) {
    return E{{lazy::sub(a.c[0], b.c[0])}};
  }
  __device__ static __forceinline__ E mul(const E& a, const E& b) {
    return E{{lazy::mul(a.c[0], b.c[0])}};
  }
  __device__ static __forceinline__ E mul_b3(const E& a) {
    return E{{mul12(a.c[0])}};
  }
  __device__ static __forceinline__ E canon(const E& a) {
    return E{{lazy::canon(a.c[0])}};
  }
};

struct G2Lazy {
  static constexpr int NFP = 2;
  struct E {
    Fp c[2];
  };
  __device__ static __forceinline__ E add(const E& a, const E& b) {
    return E{{lazy::add(a.c[0], b.c[0]), lazy::add(a.c[1], b.c[1])}};
  }
  __device__ static __forceinline__ E sub(const E& a, const E& b) {
    return E{{lazy::sub(a.c[0], b.c[0]), lazy::sub(a.c[1], b.c[1])}};
  }
  // Karatsuba: (t0 - t1) + ((a0 + a1)(b0 + b1) - t0 - t1) u
  __device__ static __forceinline__ E mul(const E& a, const E& b) {
    const Fp t0 = lazy::mul(a.c[0], b.c[0]);
    const Fp t1 = lazy::mul(a.c[1], b.c[1]);
    const Fp t2 = lazy::mul(lazy::add(a.c[0], a.c[1]),
                            lazy::add(b.c[0], b.c[1]));
    return E{{lazy::sub(t0, t1), lazy::sub(lazy::sub(t2, t0), t1)}};
  }
  // (a0 + a1 u)(12 + 12u) = 12(a0 - a1) + 12(a0 + a1) u
  __device__ static __forceinline__ E mul_b3(const E& a) {
    return E{{mul12(lazy::sub(a.c[0], a.c[1])),
              mul12(lazy::add(a.c[0], a.c[1]))}};
  }
  __device__ static __forceinline__ E canon(const E& a) {
    return E{{lazy::canon(a.c[0]), lazy::canon(a.c[1])}};
  }
};

}  // namespace lazy
}  // namespace bz
