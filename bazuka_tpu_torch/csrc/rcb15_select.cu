// Kernels K3 and K5: complete curve addition with a per-lane select,
//   out = mask ? acc + Q : acc,
// over G1 (coordinates in Fp) and G2 (coordinates in Fp2), with Q
// projective.  RCB15 algorithm 7 (a = 0): one branch-free formula that is
// right for doubling, identity and inverses.
//
// Replaces the Pallas kernels of bazuka_tpu/ops/pallas_msm.py:
//   K3 _g1_add_select_call  (API add_select_lm)
//   K5 _g2_add_select_call  (API add_select_g2_lm)
// The field adapters and the formula are rcb15.cuh's, shared with K6-K7
// (curve_add.cu).  The mixed adds K2/K4 (affine Q) are madd_select.cu's,
// on the lazy-reduction field code of fp_lazy.cuh.
//
// Layout: limb-major (planes, 24, L) int32 with 16-bit payloads; mask is
// one byte per lane.  One thread per lane.  Lanes where the mask is 0 copy
// acc and do no arithmetic.
//
// What bounds it on an H100: per active lane K3 does 12 Fp multiplies
// (7056 IMAD at 588 each), K5 36 (21168), against 865 and 1729 bytes
// moved; at 16.7e12 IMAD/s and 3.35 TB/s both are bound by the integer
// multiplies, not by the bytes.
//
// What the simple design leaves on the table: one thread holds a whole
// G2 point pair (over 300 live 32-bit words) and spills to local memory;
// the multiplies are plain 64-bit products instead of carry-chained
// mad.lo.cc/madc.hi.cc, and every operation reduces fully.  Moving K3/K5
// onto fp_lazy.cuh, as K2/K4 did, is the next step.

#include "rcb15.cuh"

namespace {

using bz::G1F;
using bz::G2F;
using bz::NLIMB;

template <class K, bool AFFINE_Q>
__global__ void __launch_bounds__(128)
    add_select_kernel(const int32_t* __restrict__ acc,
                      const int32_t* __restrict__ q,
                      const uint8_t* __restrict__ mask,
                      int32_t* __restrict__ out, long long L) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  if (!mask[lane]) {
    constexpr int ROWS = 3 * K::PLANES * NLIMB;
    for (int r = 0; r < ROWS; ++r) out[r * L + lane] = acc[r * L + lane];
    return;
  }
  bz::rcb15_add<K, AFFINE_Q>(acc, q, out, L, lane);
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

// acc/out and q: (3*planes, 24, L); mask: (L,)
extern "C" int bz_g1_add_select(const int32_t* acc, const int32_t* q,
                                const uint8_t* mask, int32_t* out,
                                long long L, long long, void* stream) {
  return launch<G1F, false>(acc, q, mask, out, L, stream);
}

extern "C" int bz_g2_add_select(const int32_t* acc, const int32_t* q,
                                const uint8_t* mask, int32_t* out,
                                long long L, long long, void* stream) {
  return launch<G2F, false>(acc, q, mask, out, L, stream);
}
