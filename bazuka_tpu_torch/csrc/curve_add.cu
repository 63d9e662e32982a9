// Kernels K6-K7: complete projective curve addition out = P + Q, with no
// select, over G1 (coordinates in Fp) and G2 (coordinates in Fp2).  RCB15
// algorithm 7 (a = 0): one branch-free formula that is right for
// doubling, identity and inverses.
//
// Replaces the Pallas kernels of bazuka_tpu/ops/pallas_curve.py:
//   K6 _g1_add_call (API pallas_g1_add)
//   K7 _g2_add_call (API pallas_g2_add)
// which `weierstrass.proj_add` reaches on keygen's path: the fixed-base
// window table and the 32 window adds per scalar of `batch_gen_mul`.  The
// field adapters and the formula are rcb15.cuh's.
//
// Layout: limb-major (planes, 24, L) int32 with 16-bit payloads, P, Q and
// out all projective (3 planes on G1, 6 on G2).  One thread per lane,
// lanes bounds-checked, so any L is taken.
//
// What bounds it on an H100: per lane K6 does 12 Fp multiplies (7056 IMAD
// at 588 each) against 864 bytes moved, K7 36 (21168 IMAD) against 1728
// bytes; at 16.7e12 IMAD/s and 3.35 TB/s both are bound by the integer
// multiplies.  The simple design: one thread holds a whole point pair on
// mont.cuh's fully reduced multiply, so K7 meets the 255-register cap and
// spills.  add_select.cu's lazy field code and six-slot schedule of the
// projective add (K3/K5) are the way to redesign it.

#include "rcb15.cuh"

namespace {

template <class K>
__global__ void __launch_bounds__(128)
    add_kernel(const int32_t* __restrict__ p, const int32_t* __restrict__ q,
               int32_t* __restrict__ out, long long L) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  bz::rcb15_add<K>(p, q, out, L, lane);
}

template <class K>
int launch(const int32_t* p, const int32_t* q, int32_t* out, long long L,
           void* stream) {
  const int block = 128;
  const long long grid = (L + block - 1) / block;
  add_kernel<K><<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(p, q, out,
                                                                     L);
  return (int)cudaGetLastError();
}

}  // namespace

// p/q/out: (3*planes, 24, L)
extern "C" int bz_g1_add(const int32_t* p, const int32_t* q, int32_t* out,
                         long long L, long long, void* stream) {
  return launch<bz::G1F>(p, q, out, L, stream);
}

extern "C" int bz_g2_add(const int32_t* p, const int32_t* q, int32_t* out,
                         long long L, long long, void* stream) {
  return launch<bz::G2F>(p, q, out, L, stream);
}
