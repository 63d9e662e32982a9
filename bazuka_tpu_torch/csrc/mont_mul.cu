// Kernel K1: batched Montgomery multiply out = a*b*R^-1 mod p, Fr or Fp.
//
// Replaces the Pallas kernel bazuka_tpu/ops/pallas_field.py:_mont_mul_call
// (body _kernel_body, API pallas_mont_mul).  The TPU kernel relaid the
// batch limb-major (n, B/128, 128) so each limb product was one vreg
// multiply over 16x16-bit limbs; here each thread owns one element: it
// reads the element's n 16-bit limbs (row-major (B, n) int32, the layout
// the port's tensors already have), packs them into n/2 32-bit words, runs
// CIOS Montgomery with 64-bit partial products and writes canonical limbs.
//
// What bounds it on an H100: per element it moves 3*n*4 bytes (two inputs
// and the output: 192 B for Fr, 288 B for Fp) and issues at least
// 4*s^2 + s 32-bit integer multiply-adds for s words (264 for Fr, 588 for
// Fp: a low and a high IMAD per word product, s^2 for a*b and s^2 + s for
// the reduction).  At 3.35 TB/s and the card's IMAD rate (64 per SM per
// clock, 132 SMs, 1.98 GHz: about 16.7e12/s) the bytes take longer than
// the multiplies for both fields, so the kernel is memory-bound.
//
// What the simple design leaves on the table: the loads are scalar 4-byte
// reads strided by the row length (each warp still consumes whole cache
// lines, but in n separate instructions), and the int32 lanes carry 16-bit
// payloads, so half of the bytes moved are zeros.  A packed 32-bit layout
// and 16-byte vector loads would cut the traffic in half; fusing the
// butterfly add/sub of the NTT into the same pass would remove two more
// passes over the data.

#include "mont.cuh"

namespace {

template <class F>
__global__ void __launch_bounds__(256)
    mont_mul_kernel(const int32_t* __restrict__ a,
                    const int32_t* __restrict__ b, int32_t* __restrict__ out,
                    long long n_elems, long long b_rows) {
  constexpr int NW = F::NW;
  constexpr int NL = 2 * NW;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_elems) return;
  const long long brow = (b_rows == n_elems) ? e : e % b_rows;
  const int32_t* ap = a + e * NL;
  const int32_t* bp = b + brow * NL;
  uint32_t x[NW], y[NW], r[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    x[j] = (uint32_t)ap[2 * j] | ((uint32_t)ap[2 * j + 1] << 16);
    y[j] = (uint32_t)bp[2 * j] | ((uint32_t)bp[2 * j + 1] << 16);
  }
  bz::mont_mul<F>(r, x, y);
  int32_t* op = out + e * NL;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    op[2 * j] = (int32_t)(r[j] & 0xFFFFu);
    op[2 * j + 1] = (int32_t)(r[j] >> 16);
  }
}

template <class F>
int launch(const int32_t* a, const int32_t* b, int32_t* out,
           long long n_elems, long long b_rows, void* stream) {
  const int block = 256;
  const long long grid = (n_elems + block - 1) / block;
  mont_mul_kernel<F><<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
      a, b, out, n_elems, b_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b, out: (n_elems, n) int32 limbs; b is read at row e % b_rows.
extern "C" int bz_mont_mul_fr(const int32_t* a, const int32_t* b,
                              int32_t* out, long long n_elems,
                              long long b_rows, void* stream) {
  return launch<bz::Fr>(a, b, out, n_elems, b_rows, stream);
}

extern "C" int bz_mont_mul_fp(const int32_t* a, const int32_t* b,
                              int32_t* out, long long n_elems,
                              long long b_rows, void* stream) {
  return launch<bz::Fp>(a, b, out, n_elems, b_rows, stream);
}
