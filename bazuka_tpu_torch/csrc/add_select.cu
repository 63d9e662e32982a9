// Kernels K2-K7: complete curve additions of projective points over G1
// (coordinates in Fp: K2, K3, K6) and G2 (Fp2: K4, K5, K7).  RCB15
// algorithm 7 (a = 0): one branch-free formula, right for doubling,
// identity and inverses.  K2-K5 add with a per-lane select,
//   out = mask ? acc + Q : acc,
// K6/K7 with none, out = P + Q.
//   K2/K4 mixed add, Q affine (Z2 = 1): 11 coordinate multiplies per lane,
//         the drain's rounds;
//   K3/K5 Q projective: 12, the run-merge scan, the bucket placement, the
//         suffix scans and the presum;
//   K6/K7 the same projective add on every lane: keygen's fixed-base
//         multiply (the window table and the 32 window adds per scalar).
//
// Replaces the Pallas kernels of bazuka_tpu/ops/pallas_msm.py:
//   K2 _g1_madd_select_call (API madd_select_lm)
//   K3 _g1_add_select_call  (API add_select_lm)
//   K4 _g2_madd_select_call (API madd_select_g2_lm)
//   K5 _g2_add_select_call  (API add_select_g2_lm)
// and of bazuka_tpu/ops/pallas_curve.py:
//   K6 _g1_add_call (API pallas_g1_add)
//   K7 _g2_add_call (API pallas_g2_add)
//
// Layout: limb-major (planes, 24, L) int32 with 16-bit payloads, acc (P)
// and out planes x y z (G1) or x0 x1 y0 y1 z0 z1 (G2), Q planes x y [z]
// (G1) or x0 x1 y0 y1 [z0 z1] (G2); mask one byte per lane; any L.  One
// thread per lane: a warp reads or writes one limb row as 128 contiguous
// bytes, so the loads and stores are coalesced as they stand.  Inputs may
// lie anywhere in [0, 2p); outputs are canonical.
//
// What bounds it on an H100: the integer multiply-adds.  Per active lane
// K2 does 11 Fp multiplies (6,468 IMAD at 588 each) against 769 bytes, K3
// 12 (7,056) against 865, K4 33 (19,404) against 1,537, K5 36 (21,168)
// against 1,729, K6 12 against 864 and K7 36 against 1,728; at 16.7e12
// IMAD/s and 3.35 TB/s the bytes take 35-60 % of the multiply time.
//
// The design (the field arithmetic is fp_lazy.cuh's: PTX carry chains,
// values kept in [0, 2p), one canonical subtract per output coordinate):
// - Each formula runs in an order that keeps few coordinates live: six
//   slots hold the inputs (the mixed add's five and a spare, the
//   projective add's six), as inputs die their slots take the
//   temporaries, at most one coordinate is held in registers across a
//   multiply, and each output coordinate is stored as soon as it is done.
// - K4/K5/K7 (Fp2) keep their slots in shared memory.  Each thread packs
//   its lane's acc and Q limbs into 32-bit words in its own column of the
//   block's tile (word w of the lane at tile[w * LANES + thread], so a
//   warp's access is one conflict-free row) and reads a coordinate back
//   where the formula uses it; the reads are volatile, so the compiler
//   holds no more than the formula says in registers.  No thread reads
//   another's column, so there is no barrier.  The copy in is a plain
//   coalesced load: cp.async or TMA would copy the 16-bit payloads still
//   in their int32 lanes, twice the tile, and halve the blocks an SM
//   holds.  6 Fp2 slots are 576 B per lane, 72 KiB per block of 128
//   lanes; built for 12 warps (3 blocks) per SM, K4 and K5 each take 168
//   registers and spill nothing, where the one-thread-per-lane kernels on
//   the fully reduced 64-bit field code they replaced held 8 warps and
//   spilled 1,316 B (K4) and 1,104 B (K5).  On an H100, K4 built for 8
//   warps (252 registers) ran 1.35-1.7x slower at 90,112 lanes, and with
//   blocks of 64 lanes within 1 % (kernel_ab.py against checkouts so
//   changed; PERF.md).  K5 at the run-merge scan's 180,224 lanes: 0.716
//   ms with the replay's scattered ~81 % of the lanes active, 0.206 ms
//   with the merge scan's quarter in blocks, 0.603 ms with all (26-38 % of
//   the bound; NVIDIA H100 80GB HBM3, 700 W, kernel_ab.py).
// - K2/K3/K6 (Fp) keep their six slots, 72 words, in registers.  Built
//   for 12 warps per SM K2 takes 168 registers and spills 16 B.  At 90,112
//   lanes it ran 9-16 % faster than the same formula on staged slots (128
//   registers, no spill, 16 warps) with half the lanes or all of them
//   active, and within 1.5 % with the replay's scattered mask; at 2,056
//   lanes 2-6 % faster.  Built for 16 warps (128 registers, 8 B spill) it
//   was nowhere over 2 % faster, and 10 % slower with half the lanes
//   active (kernel_ab.py; PERF.md).  K3 on the same slots: 168 registers,
//   16 B spill; at 180,224 lanes 0.158 ms (replay mask), 0.067 ms (merge),
//   0.112 ms (all active), 39-68 % of the bound (H100 80GB HBM3, 700 W,
//   kernel_ab.py).
// - Lanes whose mask is 0 copy acc and do no arithmetic; a warp with no
//   active lane does only that copy, as most warps of the run-merge scan,
//   K3/K5's most launched site, do after its first step.
// - K6/K7 are K3/K5's kernels with the select compiled out: the same
//   slots and formula.  Keygen launches them at 65,536 lanes (GEN_CHUNK):
//   1.29 waves of 128-lane blocks at 12 warps per SM on 132 SMs.  Times
//   per launch (kernel_ab.py against checkouts with the one line changed;
//   NVIDIA H100 80GB HBM3, 700 W; PERF.md):
//   - K6 built for 12 warps (168 registers, 60 B spill): 0.0405 ms for
//     one full wave (50,688 lanes), 0.0507 at 65,536, so the tail costs
//     nothing past its lanes; 64-lane blocks 0.0506.  Built for 16 warps
//     (128 registers, 16 B spill; 65,536 lanes fit one wave) 0.0465-0.0470
//     at 65,536 and 6-12 % faster at the last chunks' 64,292 and 65,535,
//     equal within 2 % at the window table's 32-4,096; for 20 warps (96
//     registers, 572 B spill) 0.0587.  K6 ships built for 16 warps.
//   - K7 (168 registers, no spill): one wave 0.144 ms, 65,536 lanes
//     0.279-0.296: the tail wave (116 blocks, one per SM) takes nearly a
//     full wave's time, as each lane's chain of dependent multiplies, not
//     the SM's issue rate, sets it.  64-lane blocks 0.283; the slots in
//     registers (spilled) 0.379 built for 12 warps (3,164 B spill) and
//     0.296 for 16 (4,452 B; one wave, but 0.236 ms at 50,688 lanes).
//     Six Fp2 slots in shared memory hold at most 403 lanes per SM, a
//     chunk of 65,536 needs 497 for one wave; K7 ships as K5 is built.

#include <cuda_runtime.h>

#include "fp_lazy.cuh"

namespace {

using bz::lazy::Fp;
using bz::lazy::G1Lazy;
using bz::lazy::G2Lazy;

constexpr int NLIMB = 24;   // 16-bit limbs of one Fp element
constexpr int NSLOT = 6;    // coordinate slots
constexpr int LANES = 128;  // lanes (threads) per block
// The slots hold X1 Y1 Z1 X2 Y2 [Z2] on entry; the mixed add has no Z2
// and takes slot 5 as its spare.
enum Slot { X1, Y1, Z1, X2, Y2, Z2, SPARE = Z2 };

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

// K4/K5's coordinate slots: this thread's column of the block's tile.
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

// K2/K3's coordinate slots: registers (every index is a constant once
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

// RCB15 algorithm 7 with Q projective:
//   t0 = X1 X2, t1 = Y1 Y2, t2 = Z1 Z2,
//   t3 = (X1 + Y1)(X2 + Y2) - t0 - t1, t4 = (Y1 + Z1)(Y2 + Z2) - t1 - t2,
//   Y3 = (X1 + Z1)(X2 + Z2) - t0 - t2, X3 = 3 t0, t2 = b3 t2,
//   Z3 = t1 + t2, t1 = t1 - t2, Y3 = b3 Y3,
//   X = t3 t1 - t4 Y3,  Y = Y3 X3 + t1 Z3,  Z = Z3 t4 + X3 t3.
// The six products take the input pairs in the order X, X + Y, X + Z, Y,
// Y + Z, Z: after the first three X1 and X2 are dead, after the fifth
// only Z1 and Z2 are left, so six slots hold every live value with at
// most one coordinate in registers across a multiply.  The slots hold
// X1 Y1 Z1 X2 Y2 Z2 on entry; the comments give what a slot holds after
// the step.
template <class K, class S>
__device__ __forceinline__ void add_formula(S& st, int32_t* __restrict__ out,
                                            long long L, long long lane) {
  using E = typename K::E;
  E a, b;  // the next product's operands
  {
    const E t0 = K::mul(st.get(X1), st.get(X2));
    // t0 held across this multiply
    const E u = K::sub(K::mul(K::add(st.get(X1), st.get(Y1)),
                              K::add(st.get(X2), st.get(Y2))),
                       t0);
    a = K::add(st.get(X1), st.get(Z1));
    st.put(X1, u);                                         // t3 + t1
    b = K::add(st.get(X2), st.get(Z2));
    st.put(X2, t0);                                        // t0
  }
  {
    const E ab = K::mul(a, b);
    const E v = K::sub(ab, st.get(X2));                    // Y3 + t2
    // v held across this multiply
    const E t1 = K::mul(st.get(Y1), st.get(Y2));
    st.put(X1, K::sub(st.get(X1), t1));                    // t3
    a = K::add(st.get(Y1), st.get(Z1));
    st.put(Y1, v);                                         // Y3 + t2
    b = K::add(st.get(Y2), st.get(Z2));
    st.put(Y2, t1);                                        // t1
  }
  {
    const E ab = K::mul(a, b);
    const E w = K::sub(ab, st.get(Y2));                    // t4 + t2
    a = st.get(Z1);
    st.put(Z1, w);                                         // t4 + t2
    b = st.get(Z2);
  }
  {
    const E t2 = K::mul(a, b);
    st.put(Y1, K::mul_b3(K::sub(st.get(Y1), t2)));         // b3 Y3
    st.put(Z1, K::sub(st.get(Z1), t2));                    // t4
    const E t2b = K::mul_b3(t2);
    const E t1 = st.get(Y2);
    st.put(Y2, K::sub(t1, t2b));                           // t1 - b3 t2
    st.put(Z2, K::add(t1, t2b));                           // Z3
  }
  {
    const E t0 = st.get(X2);
    st.put(X2, K::add(K::add(t0, t0), t0));                // X3
  }
  // slots: X1 = t3, Y1 = b3 Y3, Z1 = t4, X2 = X3, Y2 = t1 - b3 t2, Z2 = Z3
  store_coord<K>(K::canon(K::sub(K::mul(st.get(X1), st.get(Y2)),
                                 K::mul(st.get(Z1), st.get(Y1)))),
                 out, 0, L, lane);
  store_coord<K>(K::canon(K::add(K::mul(st.get(Y1), st.get(X2)),
                                 K::mul(st.get(Y2), st.get(Z2)))),
                 out, 1, L, lane);
  store_coord<K>(K::canon(K::add(K::mul(st.get(Z2), st.get(Z1)),
                                 K::mul(st.get(X2), st.get(X1)))),
                 out, 2, L, lane);
}

// One lane of a kernel whose Q has NQ coordinates: 2 (affine, the mixed
// add) or 3 (projective).  With SELECT a lane whose mask is 0 copies acc;
// without it (K6/K7) every lane adds and `mask` is not read.
template <class K, class S, int NQ, bool SELECT>
__device__ __forceinline__ void add_lane(const int32_t* __restrict__ acc,
                                         const int32_t* __restrict__ q,
                                         const uint8_t* __restrict__ mask,
                                         int32_t* __restrict__ out,
                                         long long L) {
  const long long lane = (long long)blockIdx.x * LANES + threadIdx.x;
  if (lane >= L) return;
  if constexpr (SELECT) {
    if (!mask[lane]) {
      constexpr int ROWS = 3 * K::NFP * NLIMB;
#pragma unroll 8
      for (int r = 0; r < ROWS; ++r) out[r * L + lane] = acc[r * L + lane];
      return;
    }
  }
  extern __shared__ uint32_t tile[];
  S st(tile);
  st.put(X1, load_coord<K>(acc, 0, L, lane));
  st.put(Y1, load_coord<K>(acc, 1, L, lane));
  st.put(Z1, load_coord<K>(acc, 2, L, lane));
  st.put(X2, load_coord<K>(q, 0, L, lane));
  st.put(Y2, load_coord<K>(q, 1, L, lane));
  if constexpr (NQ == 3) st.put(Z2, load_coord<K>(q, 2, L, lane));
  if constexpr (NQ == 2)
    madd_formula<K>(st, out, L, lane);
  else
    add_formula<K>(st, out, L, lane);
}

// WARPS: the resident warps per SM that the registers are sized for.
template <class K, class S, int WARPS>
__global__ void __launch_bounds__(LANES, WARPS * 32 / LANES)
    madd_select_kernel(const int32_t* __restrict__ acc,
                       const int32_t* __restrict__ q,
                       const uint8_t* __restrict__ mask,
                       int32_t* __restrict__ out, long long L) {
  add_lane<K, S, 2, true>(acc, q, mask, out, L);
}

template <class K, class S, int WARPS>
__global__ void __launch_bounds__(LANES, WARPS * 32 / LANES)
    proj_add_select_kernel(const int32_t* __restrict__ acc,
                           const int32_t* __restrict__ q,
                           const uint8_t* __restrict__ mask,
                           int32_t* __restrict__ out, long long L) {
  add_lane<K, S, 3, true>(acc, q, mask, out, L);
}

template <class K, class S, int WARPS>
__global__ void __launch_bounds__(LANES, WARPS * 32 / LANES)
    proj_add_kernel(const int32_t* __restrict__ p,
                    const int32_t* __restrict__ q,
                    int32_t* __restrict__ out, long long L) {
  add_lane<K, S, 3, false>(p, q, nullptr, out, L);
}

// Launches KERNEL(args..., L) over L lanes, first giving it the dynamic
// shared memory that its slots S take (once per kernel).
template <class S, auto KERNEL, class... Args>
int launch(long long L, void* stream, Args... args) {
  static bool configured = false;
  if (S::SMEM > 0 && !configured) {
    cudaError_t e = cudaFuncSetAttribute(
        KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(KERNEL,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const long long grid = (L + LANES - 1) / LANES;
  KERNEL<<<(unsigned)grid, LANES, S::SMEM, (cudaStream_t)stream>>>(args...,
                                                                    L);
  return (int)cudaGetLastError();
}

using G1Slots = RegSlots<G1Lazy>;
using G2Slots = TileSlots<G2Lazy>;

}  // namespace

// acc/out: (3*planes, 24, L); q: (2*planes, 24, L) affine or (3*planes,
// 24, L) projective; mask: (L,)
extern "C" int bz_g1_madd_select(const int32_t* acc, const int32_t* q,
                                 const uint8_t* mask, int32_t* out,
                                 long long L, long long, void* stream) {
  return launch<G1Slots, madd_select_kernel<G1Lazy, G1Slots, 12>>(
      L, stream, acc, q, mask, out);
}

extern "C" int bz_g1_add_select(const int32_t* acc, const int32_t* q,
                                const uint8_t* mask, int32_t* out,
                                long long L, long long, void* stream) {
  return launch<G1Slots, proj_add_select_kernel<G1Lazy, G1Slots, 12>>(
      L, stream, acc, q, mask, out);
}

extern "C" int bz_g2_madd_select(const int32_t* acc, const int32_t* q,
                                 const uint8_t* mask, int32_t* out,
                                 long long L, long long, void* stream) {
  return launch<G2Slots, madd_select_kernel<G2Lazy, G2Slots, 12>>(
      L, stream, acc, q, mask, out);
}

extern "C" int bz_g2_add_select(const int32_t* acc, const int32_t* q,
                                const uint8_t* mask, int32_t* out,
                                long long L, long long, void* stream) {
  return launch<G2Slots, proj_add_select_kernel<G2Lazy, G2Slots, 12>>(
      L, stream, acc, q, mask, out);
}

// p/q/out: (3*planes, 24, L), all projective
extern "C" int bz_g1_add(const int32_t* p, const int32_t* q, int32_t* out,
                         long long L, long long, void* stream) {
  return launch<G1Slots, proj_add_kernel<G1Lazy, G1Slots, 16>>(L, stream, p,
                                                               q, out);
}

extern "C" int bz_g2_add(const int32_t* p, const int32_t* q, int32_t* out,
                         long long L, long long, void* stream) {
  return launch<G2Slots, proj_add_kernel<G2Lazy, G2Slots, 12>>(L, stream, p,
                                                               q, out);
}
