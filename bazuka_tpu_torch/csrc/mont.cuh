// Montgomery arithmetic over the two BLS12-381 fields, for one element per
// thread, in 64-bit C: CIOS with 64-bit partial products (1,260 SASS per Fp
// multiply, kernel_ab.py).  It now serves only K6/K7 (curve_add.cu, through
// rcb15.cuh); K1-K5 run on mont_ptx.cuh's PTX carry chains.
//
// Elements are NW little-endian 32-bit words (Fr: 8, Fp: 12) in registers.
// In device memory the port keeps 16-bit limbs in int32 lanes (the JAX
// package's layout); packing two limbs into one word only reinterprets
// bits, so R stays 2^256 (Fr) and 2^384 (Fp) and every output matches the
// JAX limbs exactly.  All results are canonical (< p).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bz {

// moduli, little-endian 32-bit words
__constant__ uint32_t FR_P[8] = {
    0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
__constant__ uint32_t FP_P[12] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
    0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
    0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};

struct Fr {
  static constexpr int NW = 8;
  static constexpr uint32_t PINV = 0xffffffffu;  // -p^-1 mod 2^32
  __device__ static __forceinline__ uint32_t p(int i) { return FR_P[i]; }
};

struct Fp {
  static constexpr int NW = 12;
  static constexpr uint32_t PINV = 0xfffcfffdu;  // -p^-1 mod 2^32
  __device__ static __forceinline__ uint32_t p(int i) { return FP_P[i]; }
};

// r = a*b*2^(-32*NW) mod p for a, b < p (CIOS: one word of b per outer
// step, the reduction interleaved).  The sum before the final subtract is
// below 2p, so one conditional subtract makes it canonical.
template <class F>
__device__ __forceinline__ void mont_mul(uint32_t* r, const uint32_t* a,
                                         const uint32_t* b) {
  constexpr int NW = F::NW;
  uint32_t t[NW + 2];
#pragma unroll
  for (int j = 0; j < NW + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[NW] + c;
    t[NW] = (uint32_t)s;
    t[NW + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * F::PINV;
    s = (uint64_t)m * F::p(0) + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      s = (uint64_t)m * F::p(j) + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[NW] + c;
    t[NW - 1] = (uint32_t)s;
    t[NW] = t[NW + 1] + (uint32_t)(s >> 32);
  }
  uint32_t d[NW];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)t[j] - F::p(j) - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const bool ge = (t[NW] != 0) || (borrow == 0);
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = ge ? d[j] : t[j];
}

// r = a + b mod p for canonical a, b
template <class F>
__device__ __forceinline__ void add_mod(uint32_t* r, const uint32_t* a,
                                        const uint32_t* b) {
  constexpr int NW = F::NW;
  uint32_t s[NW];
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t t = (uint64_t)a[j] + b[j] + c;
    s[j] = (uint32_t)t;
    c = (uint32_t)(t >> 32);
  }
  uint32_t d[NW];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t t = (uint64_t)s[j] - F::p(j) - borrow;
    d[j] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  const bool ge = (c != 0) || (borrow == 0);
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = ge ? d[j] : s[j];
}

// r = a - b mod p for canonical a, b
template <class F>
__device__ __forceinline__ void sub_mod(uint32_t* r, const uint32_t* a,
                                        const uint32_t* b) {
  constexpr int NW = F::NW;
  uint32_t d[NW];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t t = (uint64_t)a[j] - b[j] - borrow;
    d[j] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  const uint32_t mask = 0u - borrow;  // add p back iff the subtract borrowed
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t t = (uint64_t)d[j] + (F::p(j) & mask) + c;
    r[j] = (uint32_t)t;
    c = (uint32_t)(t >> 32);
  }
}

}  // namespace bz
