// Kernels K2 and K4: the MSM drain's mixed add with a per-lane select,
//   out = mask ? acc + Q : acc,  acc projective, Q affine (Z2 = 1),
// over G1 (coordinates in Fp, K2) and G2 (Fp2, K4).  RCB15 algorithm 7
// with Z2 = 1 (a = 0): one branch-free formula, right for doubling,
// identity and inverses; 11 coordinate multiplies per lane.
//
// Replaces the Pallas kernels of bazuka_tpu/ops/pallas_msm.py:
//   K2 _g1_madd_select_call (API madd_select_lm)
//   K4 _g2_madd_select_call (API madd_select_g2_lm)
// K3/K5 (projective Q) stay in rcb15_select.cu on mont.cuh.
//
// Layout: limb-major (planes, 24, L) int32 with 16-bit payloads, acc/out
// planes x y z (G1) or x0 x1 y0 y1 z0 z1 (G2), Q planes x y (G1) or
// x0 x1 y0 y1 (G2); mask one byte per lane; any L.  One thread per lane:
// a warp reads or writes one limb row as 128 contiguous bytes, so the
// loads and stores are coalesced as they stand.
//
// What bounds it on an H100: the integer multiply-adds.  Per active lane
// K2 does 11 Fp multiplies (6,468 IMAD at 588 each) against 769 bytes, K4
// 33 (19,404) against 1,537; at 16.7e12 IMAD/s and 3.35 TB/s the bytes
// take about 60 % (K2) and 40 % (K4) of the multiply time.
//
// The design (the field arithmetic is fp_lazy.cuh's: PTX carry chains,
// values kept in [0, 2p), one canonical subtract per output coordinate):
// - The formula runs in an order that keeps few coordinates live: the
//   five input coordinates and one spare sit in six slots, as inputs die
//   their slots take the temporaries, the spare holds X1*X2 and later
//   t1 - t2, and each output coordinate is stored as soon as it is done.
// - K4 (Fp2) keeps its slots in shared memory.  Each thread packs its
//   lane's acc and Q limbs into 32-bit words in its own column of the
//   block's tile (word w of the lane at tile[w * LANES + thread], so a
//   warp's access is one conflict-free row) and reads a coordinate back
//   where the formula uses it; the reads are volatile, so the compiler
//   holds at most one coordinate in registers across a multiply.  No
//   thread reads another's column, so there is no barrier.  The copy in
//   is a plain coalesced load: cp.async or TMA would copy the 16-bit
//   payloads still in their int32 lanes, twice the tile, and halve the
//   blocks an SM holds.  6 Fp2 slots are 576 B per lane, 72 KiB per
//   block of 128 lanes; built for 3 blocks per SM it takes 168 registers
//   and spills nothing, 12 resident warps, where the one-thread-per-lane
//   kernel on mont.cuh held 8 and spilled 1,316 B.  On an H100, built for
//   2 blocks per SM (252 registers) it ran 1.35-1.7x slower at 90,112
//   lanes, and with blocks of 64 lanes within 1 % (kernel_ab.py against
//   checkouts so changed; PERF.md).
// - K2 (Fp) keeps its six slots, 72 words, in registers.  Built for 3
//   blocks per SM it takes 168 registers and spills 16 B, 12 resident
//   warps.  At 90,112 lanes it ran 9-16 % faster than the same formula
//   on K4's staged slots (128 registers, no spill, 16 warps) with half
//   the lanes or all of them active, and within 1.5 % with the replay's
//   scattered mask; at 2,056 lanes 2-6 % faster.  Built for 4 blocks (128
//   registers, 8 B spill) it was nowhere over 2 % faster, and 10 %
//   slower with half the lanes active (kernel_ab.py; PERF.md).
// - Lanes whose mask is 0 copy acc and do no arithmetic; a warp with no
//   active lane does only that copy.

#include <cuda_runtime.h>

#include "fp_lazy.cuh"

namespace {

using bz::lazy::Fp;
using bz::lazy::G1Lazy;
using bz::lazy::G2Lazy;

constexpr int NLIMB = 24;  // 16-bit limbs of one Fp element
constexpr int NSLOT = 6;   // coordinate slots: X1 Y1 Z1 X2 Y2 + one spare
enum Slot { X1, Y1, Z1, X2, Y2, SPARE };

// Fp plane `plane` of a limb-major array, packed into words.
__device__ __forceinline__ Fp load_fp(const int32_t* __restrict__ base,
                                      int plane, long long L,
                                      long long lane) {
  const int32_t* p = base + (long long)plane * NLIMB * L + lane;
  Fp e;
#pragma unroll
  for (int j = 0; j < 12; ++j)
    e.w[j] = (uint32_t)p[(2 * j) * L] | ((uint32_t)p[(2 * j + 1) * L] << 16);
  return e;
}

__device__ __forceinline__ void store_fp(const Fp& e,
                                         int32_t* __restrict__ base,
                                         int plane, long long L,
                                         long long lane) {
  int32_t* p = base + (long long)plane * NLIMB * L + lane;
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    p[(2 * j) * L] = (int32_t)(e.w[j] & 0xFFFFu);
    p[(2 * j + 1) * L] = (int32_t)(e.w[j] >> 16);
  }
}

constexpr int LANES = 128;  // lanes (threads) per block

// K4's coordinate slots: this thread's column of the block's tile.
template <class K>
struct TileSlots {
  using E = typename K::E;
  static constexpr int SMEM = LANES * NSLOT * K::NFP * 12 * 4;
  volatile uint32_t* col;  // tile + threadIdx.x
  __device__ explicit TileSlots(uint32_t* tile) : col(tile + threadIdx.x) {}
  __device__ __forceinline__ E get(int s) const {
    E e;
#pragma unroll
    for (int f = 0; f < K::NFP; ++f)
#pragma unroll
      for (int j = 0; j < 12; ++j)
        e.c[f].w[j] = col[((s * K::NFP + f) * 12 + j) * LANES];
    return e;
  }
  __device__ __forceinline__ void put(int s, const E& e) {
#pragma unroll
    for (int f = 0; f < K::NFP; ++f)
#pragma unroll
      for (int j = 0; j < 12; ++j)
        col[((s * K::NFP + f) * 12 + j) * LANES] = e.c[f].w[j];
  }
};

// K2's coordinate slots: registers (every index is a constant once
// inlined); the tile pointer is unused.
template <class K>
struct RegSlots {
  using E = typename K::E;
  static constexpr int SMEM = 0;
  E v[NSLOT];
  __device__ explicit RegSlots(uint32_t*) {}
  __device__ __forceinline__ E get(int s) const { return v[s]; }
  __device__ __forceinline__ void put(int s, const E& e) { v[s] = e; }
};

template <class K>
__device__ __forceinline__ typename K::E load_coord(
    const int32_t* __restrict__ base, int coord, long long L,
    long long lane) {
  typename K::E e;
#pragma unroll
  for (int f = 0; f < K::NFP; ++f)
    e.c[f] = load_fp(base, coord * K::NFP + f, L, lane);
  return e;
}

template <class K>
__device__ __forceinline__ void store_coord(const typename K::E& e,
                                            int32_t* __restrict__ out,
                                            int coord, long long L,
                                            long long lane) {
#pragma unroll
  for (int f = 0; f < K::NFP; ++f)
    store_fp(e.c[f], out, coord * K::NFP + f, L, lane);
}

template <class K, class S>
__device__ __forceinline__ void stage_inputs(S& st,
                                             const int32_t* __restrict__ acc,
                                             const int32_t* __restrict__ q,
                                             long long L, long long lane) {
  st.put(X1, load_coord<K>(acc, 0, L, lane));
  st.put(Y1, load_coord<K>(acc, 1, L, lane));
  st.put(Z1, load_coord<K>(acc, 2, L, lane));
  st.put(X2, load_coord<K>(q, 0, L, lane));
  st.put(Y2, load_coord<K>(q, 1, L, lane));
}

// RCB15 algorithm 7 with Z2 = 1:
//   t0 = X1 X2, t1 = Y1 Y2, t3 = (X1 + Y1)(X2 + Y2) - t0 - t1,
//   t4 = Y1 + Z1 Y2, Y3 = X1 + Z1 X2, X3 = 3 t0, t2 = b3 Z1,
//   Z3 = t1 + t2, t1 = t1 - t2, Y3 = b3 Y3,
//   X = t3 t1 - t4 Y3,  Y = Y3 X3 + t1 Z3,  Z = Z3 t4 + X3 t3.
// The slots hold X1 Y1 Z1 X2 Y2 on entry; the comments give what a slot
// holds after the step.  At most one coordinate is held in registers
// across a multiply.
template <class K, class S>
__device__ __forceinline__ void madd_formula(S& st, int32_t* __restrict__ out,
                                             long long L, long long lane) {
  using E = typename K::E;
  st.put(SPARE, K::mul(st.get(X1), st.get(X2)));           // spare: t0
  {
    const E u = K::sub(K::mul(K::add(st.get(X1), st.get(Y1)),
                              K::add(st.get(X2), st.get(Y2))),
                       st.get(SPARE));
    st.put(X1, K::add(st.get(X1), K::mul(st.get(Z1), st.get(X2))));  // Y3
    st.put(X2, u);                                         // t3 + t1
  }
  const E t1 = K::mul(st.get(Y1), st.get(Y2));
  st.put(X2, K::sub(st.get(X2), t1));                      // t3
  st.put(Y1, K::add(st.get(Y1), K::mul(st.get(Z1), st.get(Y2))));  // t4
  {
    const E t0 = st.get(SPARE);
    st.put(Y2, K::add(K::add(t0, t0), t0));                // X3
  }
  {
    const E t2 = K::mul_b3(st.get(Z1));
    st.put(Z1, K::add(t1, t2));                            // Z3
    st.put(SPARE, K::sub(t1, t2));                         // t1 - t2
  }
  st.put(X1, K::mul_b3(st.get(X1)));                       // b3 Y3
  // slots: X1 = b3 Y3, Y1 = t4, Z1 = Z3, X2 = t3, Y2 = X3, spare = t1 - t2
  store_coord<K>(K::canon(K::sub(K::mul(st.get(X2), st.get(SPARE)),
                                 K::mul(st.get(Y1), st.get(X1)))),
                 out, 0, L, lane);
  store_coord<K>(K::canon(K::add(K::mul(st.get(X1), st.get(Y2)),
                                 K::mul(st.get(SPARE), st.get(Z1)))),
                 out, 1, L, lane);
  store_coord<K>(K::canon(K::add(K::mul(st.get(Z1), st.get(Y1)),
                                 K::mul(st.get(Y2), st.get(X2)))),
                 out, 2, L, lane);
}

template <class K, class S, int MINB>
__global__ void __launch_bounds__(LANES, MINB)
    madd_select_kernel(const int32_t* __restrict__ acc,
                       const int32_t* __restrict__ q,
                       const uint8_t* __restrict__ mask,
                       int32_t* __restrict__ out, long long L) {
  const long long lane = (long long)blockIdx.x * LANES + threadIdx.x;
  if (lane >= L) return;
  if (!mask[lane]) {
    constexpr int ROWS = 3 * K::NFP * NLIMB;
#pragma unroll 8
    for (int r = 0; r < ROWS; ++r) out[r * L + lane] = acc[r * L + lane];
    return;
  }
  extern __shared__ uint32_t tile[];
  S st(tile);
  stage_inputs<K>(st, acc, q, L, lane);
  madd_formula<K>(st, out, L, lane);
}

template <class K, class S, int MINB>
int launch(const int32_t* acc, const int32_t* q, const uint8_t* mask,
           int32_t* out, long long L, void* stream) {
  auto kernel = madd_select_kernel<K, S, MINB>;
  static bool configured = false;
  if (S::SMEM > 0 && !configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const long long grid = (L + LANES - 1) / LANES;
  kernel<<<(unsigned)grid, LANES, S::SMEM, (cudaStream_t)stream>>>(
      acc, q, mask, out, L);
  return (int)cudaGetLastError();
}

}  // namespace

// acc/out: (3*planes, 24, L); q: (2*planes, 24, L); mask: (L,)
extern "C" int bz_g1_madd_select(const int32_t* acc, const int32_t* q,
                                 const uint8_t* mask, int32_t* out,
                                 long long L, long long, void* stream) {
  return launch<G1Lazy, RegSlots<G1Lazy>, 3>(acc, q, mask, out, L, stream);
}

extern "C" int bz_g2_madd_select(const int32_t* acc, const int32_t* q,
                                 const uint8_t* mask, int32_t* out,
                                 long long L, long long, void* stream) {
  return launch<G2Lazy, TileSlots<G2Lazy>, 3>(acc, q, mask, out, L, stream);
}
