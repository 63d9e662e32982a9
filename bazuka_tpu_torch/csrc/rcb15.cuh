// The complete projective addition law for a = 0 short-Weierstrass curves
// (Renes-Costello-Batina 2015, algorithm 7) over BLS12-381's G1 and G2, for
// one point pair per thread.  Used by curve_add.cu (kernels K6-K7, plain
// add); the add-select kernels K2-K5 are add_select.cu's, on fp_lazy.cuh.
//
// One template serves both groups: the coordinate field is Fp (G1F) or Fp2
// with a Karatsuba multiply (G2F).  b3 = 3b is 12 on G1 and 12+12i on G2;
// both products are shift-add chains, as in the TPU kernels.  The Fp
// multiply is mont.cuh's.  Every output is canonical, so the
// projective coordinates equal, limb for limb, those of the same formula
// evaluated by the plain PyTorch versions or the JAX package.
//
// Layout: limb-major (planes, 24, L) int32 with 16-bit payloads, planes
// x y z (G1) or x0 x1 y0 y1 z0 z1 (G2).  One thread per lane, so
// neighbouring threads read neighbouring words.
#pragma once

#include "mont.cuh"

namespace bz {

constexpr int NLIMB = 24;  // 16-bit limbs of one Fp element

struct G1F {
  static constexpr int PLANES = 1;  // Fp planes per coordinate
  struct E {
    uint32_t w[12];
  };
  __device__ static __forceinline__ E add(const E& a, const E& b) {
    E r;
    add_mod<Fp>(r.w, a.w, b.w);
    return r;
  }
  __device__ static __forceinline__ E sub(const E& a, const E& b) {
    E r;
    sub_mod<Fp>(r.w, a.w, b.w);
    return r;
  }
  __device__ static __forceinline__ E mul(const E& a, const E& b) {
    E r;
    mont_mul<Fp>(r.w, a.w, b.w);
    return r;
  }
  __device__ static __forceinline__ E mul12(const E& x) {
    const E x2 = add(x, x);
    const E x4 = add(x2, x2);
    const E x8 = add(x4, x4);
    return add(x8, x4);
  }
  __device__ static __forceinline__ E mul_b3(const E& x) { return mul12(x); }
  __device__ static __forceinline__ void load(E& e, const int32_t* base,
                                              int plane, long long L,
                                              long long lane) {
    const int32_t* p = base + (long long)plane * NLIMB * L + lane;
#pragma unroll
    for (int j = 0; j < 12; ++j)
      e.w[j] = (uint32_t)p[(2 * j) * L] | ((uint32_t)p[(2 * j + 1) * L] << 16);
  }
  __device__ static __forceinline__ void store(const E& e, int32_t* base,
                                               int plane, long long L,
                                               long long lane) {
    int32_t* p = base + (long long)plane * NLIMB * L + lane;
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      p[(2 * j) * L] = (int32_t)(e.w[j] & 0xFFFFu);
      p[(2 * j + 1) * L] = (int32_t)(e.w[j] >> 16);
    }
  }
};

struct G2F {
  static constexpr int PLANES = 2;
  struct E {
    G1F::E c0, c1;
  };
  __device__ static __forceinline__ E add(const E& a, const E& b) {
    return E{G1F::add(a.c0, b.c0), G1F::add(a.c1, b.c1)};
  }
  __device__ static __forceinline__ E sub(const E& a, const E& b) {
    return E{G1F::sub(a.c0, b.c0), G1F::sub(a.c1, b.c1)};
  }
  // Karatsuba: (t0 - t1) + ((a0+a1)(b0+b1) - t0 - t1) u
  __device__ static __forceinline__ E mul(const E& a, const E& b) {
    const G1F::E t0 = G1F::mul(a.c0, b.c0);
    const G1F::E t1 = G1F::mul(a.c1, b.c1);
    const G1F::E t2 =
        G1F::mul(G1F::add(a.c0, a.c1), G1F::add(b.c0, b.c1));
    return E{G1F::sub(t0, t1), G1F::sub(G1F::sub(t2, t0), t1)};
  }
  // (a0 + a1 u)(12 + 12 u) = 12(a0 - a1) + 12(a0 + a1) u
  __device__ static __forceinline__ E mul_b3(const E& a) {
    return E{G1F::mul12(G1F::sub(a.c0, a.c1)),
             G1F::mul12(G1F::add(a.c0, a.c1))};
  }
  __device__ static __forceinline__ void load(E& e, const int32_t* base,
                                              int plane, long long L,
                                              long long lane) {
    G1F::load(e.c0, base, 2 * plane, L, lane);
    G1F::load(e.c1, base, 2 * plane + 1, L, lane);
  }
  __device__ static __forceinline__ void store(const E& e, int32_t* base,
                                               int plane, long long L,
                                               long long lane) {
    G1F::store(e.c0, base, 2 * plane, L, lane);
    G1F::store(e.c1, base, 2 * plane + 1, L, lane);
  }
};

// out[lane] = p[lane] + q[lane], all projective (3 coordinates).
template <class K>
__device__ __forceinline__ void rcb15_add(const int32_t* __restrict__ p,
                                          const int32_t* __restrict__ q,
                                          int32_t* __restrict__ out,
                                          long long L, long long lane) {
  using E = typename K::E;
  E X1, Y1, Z1, X2, Y2;
  K::load(X1, p, 0, L, lane);
  K::load(Y1, p, 1, L, lane);
  K::load(Z1, p, 2, L, lane);
  K::load(X2, q, 0, L, lane);
  K::load(Y2, q, 1, L, lane);
  const E t0 = K::mul(X1, X2);
  const E t1 = K::mul(Y1, Y2);
  const E t3 = K::sub(K::mul(K::add(X1, Y1), K::add(X2, Y2)), K::add(t0, t1));
  E Z2;
  K::load(Z2, q, 2, L, lane);
  const E t2 = K::mul(Z1, Z2);
  const E t4 =
      K::sub(K::mul(K::add(Y1, Z1), K::add(Y2, Z2)), K::add(t1, t2));
  const E Y3 =
      K::sub(K::mul(K::add(X1, Z1), K::add(X2, Z2)), K::add(t0, t2));
  const E X3 = K::add(K::add(t0, t0), t0);
  const E t2b = K::mul_b3(t2);
  const E Z3 = K::add(t1, t2b);
  const E t1m = K::sub(t1, t2b);
  const E Y3b = K::mul_b3(Y3);
  K::store(K::sub(K::mul(t3, t1m), K::mul(t4, Y3b)), out, 0, L, lane);
  K::store(K::add(K::mul(Y3b, X3), K::mul(t1m, Z3)), out, 1, L, lane);
  K::store(K::add(K::mul(Z3, t4), K::mul(X3, t3)), out, 2, L, lane);
}

}  // namespace bz
