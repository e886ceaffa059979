// Poseidon-Goldilocks width-12 round pieces shared by the port's kernels.
//
// Every kernel source includes this header once, so each shared library
// holds its own copy of the constant tables below, filled by that library's
// *_set_constants entry point (set_constants here). The permutation is
// 4 full, 22 partial and 4 full rounds of: add the round constants, x^7 on
// every lane (full) or on lane 0 (partial), multiply by the small-integer
// 12x12 MDS. Canonical output, bit-identical to poseidon_gl.permute_plain.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "goldilocks.cuh"

namespace pos {

constexpr int WIDTH = 12;
constexpr int HALF_F = 4;     // full rounds before and after the partial ones
constexpr int ROUNDS_P = 22;
constexpr int N_ROUNDS = 2 * HALF_F + ROUNDS_P;

__constant__ uint64_t RC[N_ROUNDS * WIDTH];  // round r, lane j at r*12 + j
__constant__ uint32_t MDS[WIDTH * WIDTH];    // row-major, each < 2^16
// M[i][j] = CIRC[(j - i) % 12] + (i == j) * DIAG[i], when M has that shape
__constant__ uint32_t CIRC[WIDTH];
__constant__ uint32_t DIAG[WIDTH];

// (hi, lo) 128-bit value mod p, left in [0, 2^64) (congruent, not
// canonical): gl::reduce128 without its final conditional subtract.
__device__ __forceinline__ uint64_t reduce128_lazy(uint64_t hi, uint64_t lo) {
  uint64_t hi_hi = hi >> 32;
  uint64_t t0 = lo - hi_hi;
  if (lo < hi_hi) t0 -= gl::EPSILON;
  uint64_t t1 = (hi & 0xFFFFFFFFull) * gl::EPSILON;
  uint64_t t2 = t0 + t1;
  if (t2 < t1) t2 += gl::EPSILON;
  return t2;
}

// a*b mod p, lazy as above. Any u64 is a valid input.
__device__ __forceinline__ uint64_t mul_lazy(uint64_t a, uint64_t b) {
  return reduce128_lazy(__umul64hi(a, b), a * b);
}

__device__ __forceinline__ uint64_t sbox(uint64_t x) {
  uint64_t x3 = gl::mul(gl::square(x), x);
  return gl::mul(gl::mul(x3, x3), x);
}

// x^7 with lazy reductions: x2, x3 = x2*x, x6 = x3^2, x7 = x6*x
__device__ __forceinline__ uint64_t sbox_lazy(uint64_t x) {
  uint64_t x3 = mul_lazy(mul_lazy(x, x), x);
  return mul_lazy(mul_lazy(x3, x3), x);
}

// (acc_lo + acc_hi * 2^32) mod p for acc_lo, acc_hi < 2^64, canonical.
__device__ __forceinline__ uint64_t reduce_split(uint64_t acc_lo,
                                                 uint64_t acc_hi) {
  uint64_t lo64 = acc_lo + (acc_hi << 32);
  uint64_t hi64 = (acc_hi >> 32) + (lo64 < acc_lo ? 1 : 0);
  return gl::reduce128(hi64, lo64);
}

// Dense small-coefficient MDS: each output lane is 12 multiply-adds of the
// coefficients into the u32 halves of the inputs (acc < 12 * 2^16 * 2^32 <
// 2^53), then one 128-bit reduction, as _mds_small in ops/poseidon_gl.py.
__device__ __forceinline__ void mds_dense(uint64_t s[WIDTH]) {
  uint32_t lo[WIDTH], hi[WIDTH];
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) {
    lo[j] = static_cast<uint32_t>(s[j]);
    hi[j] = static_cast<uint32_t>(s[j] >> 32);
  }
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) {
    uint64_t acc_lo = 0, acc_hi = 0;
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) {
      uint64_t c = MDS[i * WIDTH + j];
      acc_lo += c * lo[j];
      acc_hi += c * hi[j];
    }
    s[i] = reduce_split(acc_lo, acc_hi);
  }
}

// Circulant + diagonal MDS: out_i = sum_k CIRC[k] s_{(i+k)%12} + DIAG[i] s_i,
// 13 small-constant terms per output lane (the decomposition of
// poseidon_pallas._circ_diag).
__device__ __forceinline__ void mds_circ_diag(uint64_t s[WIDTH]) {
  uint32_t lo[WIDTH], hi[WIDTH];
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) {
    lo[j] = static_cast<uint32_t>(s[j]);
    hi[j] = static_cast<uint32_t>(s[j] >> 32);
  }
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) {
    uint64_t d = DIAG[i];
    uint64_t acc_lo = d * lo[i], acc_hi = d * hi[i];
#pragma unroll
    for (int k = 0; k < WIDTH; ++k) {
      uint64_t c = CIRC[k];
      acc_lo += c * lo[(i + k) % WIDTH];
      acc_hi += c * hi[(i + k) % WIDTH];
    }
    s[i] = reduce_split(acc_lo, acc_hi);
  }
}

enum class Mds { kDense, kCircDiag };

template <Mds kMds>
__device__ __forceinline__ void mds(uint64_t s[WIDTH]) {
  if constexpr (kMds == Mds::kDense) {
    mds_dense(s);
  } else {
    mds_circ_diag(s);
  }
}

template <Mds kMds>
__device__ __forceinline__ void full_round(uint64_t s[WIDTH], int r) {
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) s[j] = sbox(gl::add(s[j], RC[r * WIDTH + j]));
  mds<kMds>(s);
}

template <Mds kMds>
__device__ __forceinline__ void partial_round(uint64_t s[WIDTH], int r) {
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) s[j] = gl::add(s[j], RC[r * WIDTH + j]);
  s[0] = sbox(s[0]);
  mds<kMds>(s);
}

// The whole permutation in registers with the dense MDS, full rounds
// unrolled. Input: any u64 per lane (reduced once here: the reference's
// first full round is congruence-preserving).
__device__ __forceinline__ void permute_dense(uint64_t s[WIDTH]) {
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) s[j] = gl::canonical(s[j]);
#pragma unroll
  for (int r = 0; r < HALF_F; ++r) full_round<Mds::kDense>(s, r);
#pragma unroll 2
  for (int r = HALF_F; r < HALF_F + ROUNDS_P; ++r)
    partial_round<Mds::kDense>(s, r);
#pragma unroll
  for (int r = HALF_F + ROUNDS_P; r < N_ROUNDS; ++r)
    full_round<Mds::kDense>(s, r);
}

// Copy a constant set into this library's tables: rc holds the 360 round
// constants, mds the 12x12 coefficients row-major (each < 2^16), circ/diag
// its circulant + diagonal decomposition (zeros where M has no such shape;
// only the circ-diag kernel reads them). Returns a cudaError_t code.
inline int set_constants(const uint64_t* rc, const uint32_t* mds,
                         const uint32_t* circ, const uint32_t* diag) {
  cudaError_t err = cudaMemcpyToSymbol(RC, rc, sizeof(RC));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(MDS, mds, sizeof(MDS));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(CIRC, circ, sizeof(CIRC));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(DIAG, diag, sizeof(DIAG));
  return static_cast<int>(err);
}

}  // namespace pos
