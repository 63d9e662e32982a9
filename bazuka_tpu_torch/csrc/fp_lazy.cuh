// BLS12-381 Fp arithmetic with lazy reduction, for one element per
// thread: mont_ptx.cuh's PTX carry chains over Fp.  Used by add_select.cu
// (kernels K2-K7).
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
#pragma once

#include "mont_ptx.cuh"

namespace bz {
namespace lazy {

using Fp = ptx::Elem<ptx::FpMod>;

// a*b*2^-384 mod p: a, b in [0, 2p) -> [0, 2p)
__device__ __forceinline__ Fp mul(const Fp& a, const Fp& b) {
  return ptx::mul<ptx::FpMod>(a, b);
}

// a + b: [0, 2p) x [0, 2p) -> [0, 2p)
__device__ __forceinline__ Fp add(const Fp& a, const Fp& b) {
  return ptx::add<ptx::FpMod, true>(a, b);
}

// a - b: [0, 2p) x [0, 2p) -> [0, 2p)
__device__ __forceinline__ Fp sub(const Fp& a, const Fp& b) {
  return ptx::sub<ptx::FpMod, true>(a, b);
}

// [0, 2p) -> [0, p)
__device__ __forceinline__ Fp canon(const Fp& x) {
  return ptx::reduce_once<ptx::FpMod, false>(x);
}

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
