// Kernels K2-K5: complete curve addition with a per-lane select,
//   out = mask ? acc + Q : acc,
// over G1 (coordinates in Fp) and G2 (coordinates in Fp2), with Q affine
// (Z2 = 1, "madd") or projective ("add").  RCB15 algorithm 7 (a = 0): one
// branch-free formula that is right for doubling, identity and inverses.
//
// Replaces the Pallas kernels of bazuka_tpu/ops/pallas_msm.py:
//   K2 _g1_madd_select_call (API madd_select_lm)
//   K3 _g1_add_select_call  (API add_select_lm)
//   K4 _g2_madd_select_call (API madd_select_g2_lm)
//   K5 _g2_add_select_call  (API add_select_g2_lm)
// One template serves all four: the coordinate field (Fp, or Fp2 with a
// Karatsuba multiply) and whether Q is affine.  b3 = 3b is 12 on G1 and
// 12+12i on G2; both products are shift-add chains, as in the TPU kernel.
// The Fp multiply is K1's (mont.cuh).
//
// Layout: limb-major (planes, 24, L) int32 with 16-bit payloads, planes
// x y z (G1) or x0 x1 y0 y1 z0 z1 (G2); mask is one byte per lane.  One
// thread per lane, so neighbouring threads read neighbouring words.
// Lanes where the mask is 0 copy acc and do no arithmetic.
//
// What bounds it on an H100: per active lane K2 does 11 Fp multiplies
// (6468 IMAD at 588 each), K3 12 (7056), K4 33 (19404), K5 36 (21168),
// against 769, 865, 1537 and 1729 bytes moved; at 16.7e12 IMAD/s and
// 3.35 TB/s every one of the four is bound by the integer multiplies, not
// by the bytes.
//
// What the simple design leaves on the table: one thread holds a whole
// G2 point pair (over 300 live 32-bit words) and spills to local memory;
// the multiplies are plain 64-bit products instead of carry-chained
// mad.lo.cc/madc.hi.cc; and the MSM around it launches one kernel per
// drain round with a gather in between.  Several threads per element, and
// a fused bucket-accumulation kernel that keeps buckets in shared memory,
// are the next steps.

#include "mont.cuh"

namespace {

constexpr int NLIMB = 24;  // 16-bit limbs of one Fp element

struct G1F {
  static constexpr int PLANES = 1;  // Fp planes per coordinate
  struct E {
    uint32_t w[12];
  };
  __device__ static __forceinline__ E add(const E& a, const E& b) {
    E r;
    bz::add_mod<bz::Fp>(r.w, a.w, b.w);
    return r;
  }
  __device__ static __forceinline__ E sub(const E& a, const E& b) {
    E r;
    bz::sub_mod<bz::Fp>(r.w, a.w, b.w);
    return r;
  }
  __device__ static __forceinline__ E mul(const E& a, const E& b) {
    E r;
    bz::mont_mul<bz::Fp>(r.w, a.w, b.w);
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

template <class K, bool AFFINE_Q>
__global__ void __launch_bounds__(128)
    add_select_kernel(const int32_t* __restrict__ acc,
                      const int32_t* __restrict__ q,
                      const uint8_t* __restrict__ mask,
                      int32_t* __restrict__ out, long long L) {
  using E = typename K::E;
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  if (!mask[lane]) {
    constexpr int ROWS = 3 * K::PLANES * NLIMB;
    for (int r = 0; r < ROWS; ++r) out[r * L + lane] = acc[r * L + lane];
    return;
  }
  E X1, Y1, Z1, X2, Y2;
  K::load(X1, acc, 0, L, lane);
  K::load(Y1, acc, 1, L, lane);
  K::load(Z1, acc, 2, L, lane);
  K::load(X2, q, 0, L, lane);
  K::load(Y2, q, 1, L, lane);
  const E t0 = K::mul(X1, X2);
  const E t1 = K::mul(Y1, Y2);
  E t2, t4, Y3;
  const E t3 = K::sub(K::mul(K::add(X1, Y1), K::add(X2, Y2)), K::add(t0, t1));
  if constexpr (AFFINE_Q) {
    // Z2 = 1: t2 = Z1, (Y1+Z1)(Y2+1) - t1 - t2 = Y1 + Z1*Y2, likewise X
    t2 = Z1;
    t4 = K::add(Y1, K::mul(Z1, Y2));
    Y3 = K::add(X1, K::mul(Z1, X2));
  } else {
    E Z2;
    K::load(Z2, q, 2, L, lane);
    t2 = K::mul(Z1, Z2);
    t4 = K::sub(K::mul(K::add(Y1, Z1), K::add(Y2, Z2)), K::add(t1, t2));
    Y3 = K::sub(K::mul(K::add(X1, Z1), K::add(X2, Z2)), K::add(t0, t2));
  }
  const E X3 = K::add(K::add(t0, t0), t0);
  const E t2b = K::mul_b3(t2);
  const E Z3 = K::add(t1, t2b);
  const E t1m = K::sub(t1, t2b);
  const E Y3b = K::mul_b3(Y3);
  K::store(K::sub(K::mul(t3, t1m), K::mul(t4, Y3b)), out, 0, L, lane);
  K::store(K::add(K::mul(Y3b, X3), K::mul(t1m, Z3)), out, 1, L, lane);
  K::store(K::add(K::mul(Z3, t4), K::mul(X3, t3)), out, 2, L, lane);
}

template <class K, bool AFFINE_Q>
int launch(const int32_t* acc, const int32_t* q, const uint8_t* mask,
           int32_t* out, long long L, void* stream) {
  const int block = 128;
  const long long grid = (L + block - 1) / block;
  add_select_kernel<K, AFFINE_Q>
      <<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(acc, q, mask, out,
                                                           L);
  return (int)cudaGetLastError();
}

}  // namespace

// acc/out: (3*planes, 24, L); q: (2*planes or 3*planes, 24, L); mask: (L,)
extern "C" int bz_g1_madd_select(const int32_t* acc, const int32_t* q,
                                 const uint8_t* mask, int32_t* out,
                                 long long L, long long, void* stream) {
  return launch<G1F, true>(acc, q, mask, out, L, stream);
}

extern "C" int bz_g1_add_select(const int32_t* acc, const int32_t* q,
                                const uint8_t* mask, int32_t* out,
                                long long L, long long, void* stream) {
  return launch<G1F, false>(acc, q, mask, out, L, stream);
}

extern "C" int bz_g2_madd_select(const int32_t* acc, const int32_t* q,
                                 const uint8_t* mask, int32_t* out,
                                 long long L, long long, void* stream) {
  return launch<G2F, true>(acc, q, mask, out, L, stream);
}

extern "C" int bz_g2_add_select(const int32_t* acc, const int32_t* q,
                                const uint8_t* mask, int32_t* out,
                                long long L, long long, void* stream) {
  return launch<G2F, false>(acc, q, mask, out, L, stream);
}
