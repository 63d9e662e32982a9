// Kernel K1, the Montgomery multiply a*b*R^-1 mod p over Fr or Fp, and
// the two entries built on it: Fr's multiply fused into the radix-2
// stages of the NTT, and Fp's into one-launch Fermat inversions.
//
// Replaces the Pallas kernel bazuka_tpu/ops/pallas_field.py:_mont_mul_call
// (body _kernel_body, API pallas_mont_mul).  The TPU kernel relaid the
// batch limb-major (n, B/128, 128) so each limb product was one vreg
// multiply over 16x16-bit limbs, and XLA fused the NTT's butterfly add and
// sub and the inversion's scan around it.  Here each thread owns one
// element (one butterfly, one inversion) in the layout the port's tensors
// have, row-major (B, n) int32 with 16-bit payloads, and packs the n limbs
// into n/2 32-bit words.  The field core is mont_ptx.cuh's: PTX carry
// chains over two accumulators.  Fr has no lazy headroom (2p < R < 4p), so
// its products take canonical operands and end in one subtract of p; the
// inversion's Fp products stay in [0, 2p) until the store.  Every output
// is canonical and equal, limb for limb, to the plain PyTorch versions
// (ops/field_kernel.py) and to the JAX package.
//
// Entries (each returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments it does not take: a row pointer that is not 16-byte aligned,
// more than 2^31 elements):
//   bz_mont_mul_fr/fp  out = a*b, row e of b being e mod b_rows, for
//       one operand canonical and the other below R.  Bytes:
//       per element 3*n*4 (two rows in, one out: 192 B Fr, 288 B Fp)
//       against 4s^2 + s IMAD for s words (264, 588): bytes-bound on an
//       H100 (3.35 TB/s against about 16.7e12 IMAD/s).  So each row moves
//       as n/4 16-byte vector accesses (4 Fr, 6 Fp), and the row of b is
//       e mod b_rows by a multiply-high with a host-computed reciprocal,
//       not a 64-bit division.
//   bz_ntt_stages_fr   the stages of a decimation-in-time radix-2 NTT of n
//       bit-reversed elements in x, y scratch, result in x: one pass runs
//       stages 0..k-1 on blocks of 2^k consecutive elements in shared
//       memory (k = min(10, log2 n): 32 KiB per block), then one launch per remaining stage reads u and v of its
//       pair straight from the (n/2h, 2, h) layout and writes u + w v and
//       u - w v, out of place, alternating x and y.  Stage s takes its
//       twiddles from rows [2^s - 1, 2^(s+1) - 1) of tw.  Given a row
//       length m < n, x is n/m rows each transformed on its own (the
//       four-step NTT's row transforms, bazuka_tpu/ops/ntt.py:263):
//       stages 0..log2(m)-1, tw the row length's table.  Each pass moves
//       2n rows and each butterfly costs one multiply, so the passes are
//       bytes-bound; the low pass saves k - 1 of them.
//   bz_mont_inv_fp     out = a^(p-2) (0 -> 0): one thread per element,
//       sliding 4-bit windows from the top bit over odd powers x, x^3,
//       ..., x^15, kept in the thread's own column of shared memory (8 Fp,
//       384 B a thread, 48 KiB per block of 128): 463 multiplies against
//       609 for bit-by-bit square-and-multiply, with the exponent's
//       windows in constant memory, the same for every thread.  The table
//       in registers would need 96 more words and index them by a runtime
//       digit, which spills; a fixed window's 15 powers would need 90 KiB
//       per block and halve the blocks an SM holds.  Built for 4 blocks
//       (16 warps) per SM: keygen's 2^16-element chunks, 512 blocks, run
//       in one wave on 132 SMs.  Operations-bound.
//
// What is left: the single-stage passes could take two or more stages
// each (radix 4 or 8 through shared memory) and halve the passes over the
// data; the int32 lanes carry 16-bit payloads, so half the bytes moved
// are zeros, and a packed layout would halve them for every kernel.

#include <cuda_runtime.h>

#include "mont_ptx.cuh"

namespace {

using bz::ptx::Elem;
using bz::ptx::FpMod;
using bz::ptx::FrMod;
using Fr = Elem<FrMod>;
using Fp = Elem<FpMod>;

constexpr int MUL_THREADS = 256;
constexpr int NTT_THREADS = 256;
constexpr int NTT_LOW_MAX = 10;  // 2^10 elements of 32 B: 32 KiB
constexpr int INV_LANES = 128;
constexpr long long MAX_ELEMS = 1LL << 31;

// One row: 2 NW int32 limbs holding 16-bit payloads, 16-byte aligned, as
// NW/2 vector accesses, each carrying two words.
template <class M>
__device__ __forceinline__ Elem<M> load_row(const int32_t* row) {
  const int4* v = reinterpret_cast<const int4*>(row);
  Elem<M> e;
#pragma unroll
  for (int q = 0; q < M::NW / 2; ++q) {
    const int4 t = v[q];
    e.w[2 * q] = (uint32_t)t.x | ((uint32_t)t.y << 16);
    e.w[2 * q + 1] = (uint32_t)t.z | ((uint32_t)t.w << 16);
  }
  return e;
}

template <class M>
__device__ __forceinline__ void store_row(int32_t* row, const Elem<M>& e) {
  int4* v = reinterpret_cast<int4*>(row);
#pragma unroll
  for (int q = 0; q < M::NW / 2; ++q)
    v[q] = make_int4((int)(e.w[2 * q] & 0xFFFFu), (int)(e.w[2 * q] >> 16),
                     (int)(e.w[2 * q + 1] & 0xFFFFu),
                     (int)(e.w[2 * q + 1] >> 16));
}

// a*b*R^-1 mod p for a canonical multiplicand a and any b < R: the
// product is below (p R + R p) / R = 2p in both fields, so one
// conditional subtract of p makes it canonical.
template <class M>
__device__ __forceinline__ Elem<M> mul_canon(const Elem<M>& a,
                                             const Elem<M>& b) {
  return bz::ptx::reduce_once<M, false>(bz::ptx::mul<M>(a, b));
}

// all ones iff x < p
template <class M>
__device__ __forceinline__ uint32_t below_p(const Elem<M>& x) {
  bz::ptx::sub_cc(x.w[0], M::p(0));
#pragma unroll
  for (int j = 1; j < M::NW; ++j) bz::ptx::subc_cc(x.w[j], M::p(j));
  return bz::ptx::subc(0, 0);
}

// ------------------------------------------------ K1: batched multiply

// e mod d for e < 2^31: q = umulhi(e, magic) with magic = ceil(2^32 / d)
// is floor(e / d) or one more (the error e (magic d - 2^32) / (d 2^32) is
// below e / 2^32 < 1/2); for d = 1, magic = 2^32 - 1 gives e - 1.  One
// correction each way makes r exact.
__device__ __forceinline__ uint32_t row_of(uint32_t e, uint32_t d,
                                           uint32_t magic) {
  const uint32_t q = __umulhi(e, magic);
  int r = (int)(e - q * d);
  if (r < 0) r += (int)d;
  if (r >= (int)d) r -= (int)d;
  return (uint32_t)r;
}

template <class M>
__global__ void __launch_bounds__(MUL_THREADS)
    mont_mul_kernel(const int32_t* __restrict__ a,
                    const int32_t* __restrict__ b, int32_t* __restrict__ out,
                    uint32_t n, uint32_t b_rows, uint32_t magic) {
  constexpr int NL = 2 * M::NW;
  const uint32_t e = blockIdx.x * MUL_THREADS + threadIdx.x;
  if (e >= n) return;
  const uint32_t r = row_of(e, b_rows, magic);
  const Elem<M> x = load_row<M>(a + (size_t)e * NL);
  const Elem<M> y = load_row<M>(b + (size_t)r * NL);
  // The JAX kernel's contract, a*b < p R: one operand canonical, the
  // other any 16-bit limbs (the row evaluation's redundant sums).  The
  // canonical one becomes the multiplicand, whose bound t < a + p keeps
  // the accumulator within its words.
  const uint32_t y_canon = below_p<M>(y);
  Elem<M> u, v;
#pragma unroll
  for (int j = 0; j < M::NW; ++j) {
    u.w[j] = (y.w[j] & y_canon) | (x.w[j] & ~y_canon);
    v.w[j] = (x.w[j] & y_canon) | (y.w[j] & ~y_canon);
  }
  store_row<M>(out + (size_t)e * NL, mul_canon<M>(u, v));
}

bool misaligned(const void* p) { return ((uintptr_t)p & 15) != 0; }

template <class M>
int launch_mul(const int32_t* a, const int32_t* b, int32_t* out,
               long long n, long long b_rows, void* stream) {
  if (n == 0) return 0;
  if (n < 0 || n > MAX_ELEMS || b_rows < 1 || b_rows > n ||
      misaligned(a) || misaligned(b) || misaligned(out))
    return (int)cudaErrorInvalidValue;
  const uint32_t d = (uint32_t)b_rows;
  const uint32_t magic =
      d == 1 ? 0xffffffffu : (uint32_t)(((1ULL << 32) + d - 1) / d);
  const long long grid = (n + MUL_THREADS - 1) / MUL_THREADS;
  mont_mul_kernel<M><<<(unsigned)grid, MUL_THREADS, 0,
                       (cudaStream_t)stream>>>(a, b, out, (uint32_t)n, d,
                                               magic);
  return (int)cudaGetLastError();
}

// ----------------------------------------- K1 Fr as the NTT's stages

// (u, v) -> (u + w v, u - w v) mod p, all canonical
__device__ __forceinline__ void butterfly(Fr& u, Fr& v, const Fr& w) {
  const Fr t = mul_canon<FrMod>(v, w);
  v = bz::ptx::sub<FrMod, false>(u, t);
  u = bz::ptx::add<FrMod, false>(u, t);
}

// Stages 0..k-1 on the block's 2^k consecutive elements, held as packed
// words in shared memory (word w of element i at sm[(w << k) + i], so
// neighbouring butterflies read neighbouring banks).  src may equal dst:
// every thread has read before any writes.
__global__ void __launch_bounds__(NTT_THREADS)
    ntt_low_kernel(const int32_t* src, int32_t* dst,
                   const int32_t* __restrict__ tw, int k) {
  extern __shared__ uint32_t sm[];
  const int m = 1 << k;
  const size_t base = (size_t)blockIdx.x << k;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const Fr x = load_row<FrMod>(src + (base + i) * 16);
#pragma unroll
    for (int w = 0; w < 8; ++w) sm[(w << k) + i] = x.w[w];
  }
  __syncthreads();
  for (int s = 0; s < k; ++s) {
    const int h = 1 << s;
    for (int t = threadIdx.x; t < m / 2; t += blockDim.x) {
      const int j = t & (h - 1);
      const int u = ((t >> s) << (s + 1)) | j;
      Fr a, b;
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        a.w[w] = sm[(w << k) + u];
        b.w[w] = sm[(w << k) + u + h];
      }
      butterfly(a, b, load_row<FrMod>(tw + (size_t)(h - 1 + j) * 16));
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        sm[(w << k) + u] = a.w[w];
        sm[(w << k) + u + h] = b.w[w];
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    Fr x;
#pragma unroll
    for (int w = 0; w < 8; ++w) x.w[w] = sm[(w << k) + i];
    store_row<FrMod>(dst + (base + i) * 16, x);
  }
}

// Stage s over the whole array: thread t is butterfly j = t mod h of
// group t / h, h = 2^s; u at row 2h (t / h) + j, v at u + h.
__global__ void __launch_bounds__(NTT_THREADS)
    ntt_stage_kernel(const int32_t* __restrict__ src,
                     int32_t* __restrict__ dst,
                     const int32_t* __restrict__ tw, uint32_t half_n,
                     int s) {
  const uint32_t t = blockIdx.x * NTT_THREADS + threadIdx.x;
  if (t >= half_n) return;
  const uint32_t h = 1u << s;
  const uint32_t j = t & (h - 1);
  const uint32_t u = ((t >> s) << (s + 1)) | j;
  Fr a = load_row<FrMod>(src + (size_t)u * 16);
  Fr b = load_row<FrMod>(src + (size_t)(u + h) * 16);
  butterfly(a, b, load_row<FrMod>(tw + (size_t)(h - 1 + j) * 16));
  store_row<FrMod>(dst + (size_t)u * 16, a);
  store_row<FrMod>(dst + (size_t)(u + h) * 16, b);
}

// ----------------------------------- K1 Fp as the Fermat inversion

// p - 2 in sliding 4-bit windows from its top bit: acc = x^INV_FIRST, then
// per step INV_SQR[i] squarings and one multiply by x^INV_DIGIT[i] (odd).
// p - 2 is odd, so the last window ends at bit 0.  Generated from p - 2
// by ops/field_kernel.py:fermat_windows (tests/test_torch_k1.py holds the
// two equal).
constexpr int INV_FIRST = 13;
constexpr int INV_STEPS = 78;
__constant__ uint8_t INV_SQR[INV_STEPS] = {
    9, 4, 7, 4, 6, 6, 4, 4, 6, 6, 6, 3, 7, 4, 6, 5, 4, 8, 6, 3,
    3, 6, 4, 3, 3, 6, 4, 5, 4, 8, 3, 5, 7, 7, 5, 4, 3, 5, 4, 8,
    5, 2, 9, 5, 3, 8, 3, 7, 9, 4, 5, 4, 4, 4, 3, 5, 6, 5, 4, 4,
    4, 4, 4, 2, 6, 4, 5, 4, 4, 4, 4, 4, 4, 4, 3, 4, 4, 5};
__constant__ uint8_t INV_DIGIT[INV_STEPS] = {
    1, 1, 15, 5, 7, 11, 15, 15, 13, 13, 9, 3, 13, 13, 15, 13, 9, 13, 11, 5,
    3, 13, 7, 3, 1, 7, 7, 9, 7, 9, 7, 7, 5, 9, 11, 15, 3, 7, 3, 13,
    5, 1, 15, 13, 3, 15, 3, 9, 15, 5, 11, 15, 15, 15, 7, 11, 5, 9, 15, 15,
    15, 15, 13, 3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 5, 5, 5, 9};

// This thread's odd powers x^(2i+1), word w at col[(i * 12 + w) * LANES]
__device__ __forceinline__ void put_power(uint32_t* col, int i, const Fp& x) {
#pragma unroll
  for (int w = 0; w < 12; ++w) col[(i * 12 + w) * INV_LANES] = x.w[w];
}
__device__ __forceinline__ Fp get_power(const uint32_t* col, int i) {
  Fp x;
#pragma unroll
  for (int w = 0; w < 12; ++w) x.w[w] = col[(i * 12 + w) * INV_LANES];
  return x;
}

__global__ void __launch_bounds__(INV_LANES, 4)
    mont_inv_fp_kernel(const int32_t* __restrict__ a,
                       int32_t* __restrict__ out, uint32_t n) {
  __shared__ uint32_t powers[8 * 12 * INV_LANES];
  const uint32_t e = blockIdx.x * INV_LANES + threadIdx.x;
  if (e >= n) return;  // no thread reads another's column: no barrier
  uint32_t* col = powers + threadIdx.x;
  const Fp x = load_row<FpMod>(a + (size_t)e * 24);
  const Fp x2 = bz::ptx::mul<FpMod>(x, x);
  Fp t = x;
  put_power(col, 0, t);
#pragma unroll 1
  for (int i = 1; i < 8; ++i) {
    t = bz::ptx::mul<FpMod>(t, x2);
    put_power(col, i, t);
  }
  Fp acc = get_power(col, INV_FIRST >> 1);
#pragma unroll 1
  for (int i = 0; i < INV_STEPS; ++i) {
#pragma unroll 1
    for (int q = 0; q < INV_SQR[i]; ++q) acc = bz::ptx::mul<FpMod>(acc, acc);
    acc = bz::ptx::mul<FpMod>(acc, get_power(col, INV_DIGIT[i] >> 1));
  }
  store_row<FpMod>(out + (size_t)e * 24,
                   bz::ptx::reduce_once<FpMod, false>(acc));
}

}  // namespace

// a, b, out: (n_elems, n) int32 limbs; b is read at row e mod b_rows.
extern "C" int bz_mont_mul_fr(const int32_t* a, const int32_t* b,
                              int32_t* out, long long n_elems,
                              long long b_rows, void* stream) {
  return launch_mul<FrMod>(a, b, out, n_elems, b_rows, stream);
}

extern "C" int bz_mont_mul_fp(const int32_t* a, const int32_t* b,
                              int32_t* out, long long n_elems,
                              long long b_rows, void* stream) {
  return launch_mul<FpMod>(a, b, out, n_elems, b_rows, stream);
}

// x: (n, 16) bit-reversed Montgomery limbs, transformed in place; y: (n,
// 16) scratch; tw: (m - 1, 16) packed stage twiddles of the row length m.
// x holds n / m rows of m elements (m = 0 or n: one row, the whole
// array; m a power of two, n any multiple of it), each transformed on its
// own: stages 0..log2(m) - 1.  A
// butterfly of stage s < log2(m) pairs rows u and u + 2^s inside one
// aligned block of 2^(s+1) <= m, so it never crosses a row: the low pass
// and the single-stage launches index the whole array as they would for
// one row.  The low pass goes to y when an odd number of single stages
// follows, so the last stage writes x.
extern "C" int bz_ntt_stages_fr(int32_t* x, int32_t* y, const int32_t* tw,
                                long long n, long long m, void* stream) {
  if (m == 0) m = n;
  if (n < 1 || n > MAX_ELEMS || m < 1 || (m & (m - 1)) != 0 || n % m != 0 ||
      misaligned(x) || misaligned(y) || misaligned(tw))
    return (int)cudaErrorInvalidValue;
  int log_m = 0;
  while ((1LL << log_m) < m) ++log_m;
  if (log_m == 0) return 0;
  const int k = log_m < NTT_LOW_MAX ? log_m : NTT_LOW_MAX;
  const int b = 1 << k;
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* cur = ((log_m - k) % 2) ? y : x;
  ntt_low_kernel<<<(unsigned)(n >> k),
                   b / 2 < NTT_THREADS ? b / 2 : NTT_THREADS,
                   (size_t)b * 8 * 4, st>>>(x, cur, tw, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((n / 2 + NTT_THREADS - 1) / NTT_THREADS);
  for (int s = k; s < log_m; ++s) {
    int32_t* next = cur == x ? y : x;
    ntt_stage_kernel<<<grid, NTT_THREADS, 0, st>>>(cur, next, tw,
                                                   (uint32_t)(n / 2), s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cur = next;
  }
  return 0;
}

// a, out: (n_elems, 24) int32 limbs, out = a^(p-2).
extern "C" int bz_mont_inv_fp(const int32_t* a, int32_t* out,
                              long long n_elems, long long unused,
                              void* stream) {
  (void)unused;
  if (n_elems < 0 || n_elems > MAX_ELEMS || misaligned(a) || misaligned(out))
    return (int)cudaErrorInvalidValue;
  if (n_elems == 0) return 0;
  const long long grid = (n_elems + INV_LANES - 1) / INV_LANES;
  mont_inv_fp_kernel<<<(unsigned)grid, INV_LANES, 0, (cudaStream_t)stream>>>(
      a, out, (uint32_t)n_elems);
  return (int)cudaGetLastError();
}
