// Poseidon-Goldilocks round pieces on runtime constant tables: the round
// constants and the circulant + diagonal form of the MDS in __constant__
// memory, filled by set_constants.
//
// The kernels that read the constant set from runtime tables include this
// header: poseidon_gl_soa.cu (mode "2d", the circulant + diagonal MDS) and
// poseidon_gl_mma.cu (modes "mxu"/"mxu24": the round constants and the
// canonical S-box; their MDS runs on the tensor cores). Each shared library
// holds its own copy of the tables, filled by that library's
// *_set_constants entry point. The poseidon_gl library (modes "mxu96",
// "blocked", "1d" and the fused commit) compiles the reference MDS in
// (poseidon_common.cuh) and runs the lazy body of poseidon_lazy.cuh instead.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "poseidon_common.cuh"

namespace pos {

__constant__ uint64_t RC[N_ROUNDS * WIDTH];  // round r, lane j at r*12 + j
// M[i][j] = CIRC[(j - i) % 12] + (i == j) * DIAG[i], when M has that shape
__constant__ uint32_t CIRC[WIDTH];
__constant__ uint32_t DIAG[WIDTH];

__device__ __forceinline__ uint64_t sbox(uint64_t x) {
  uint64_t x3 = gl::mul(gl::square(x), x);
  return gl::mul(gl::mul(x3, x3), x);
}

// (acc_lo + acc_hi * 2^32) mod p for acc_lo, acc_hi < 2^64, canonical.
__device__ __forceinline__ uint64_t reduce_split(uint64_t acc_lo,
                                                 uint64_t acc_hi) {
  uint64_t lo64 = acc_lo + (acc_hi << 32);
  uint64_t hi64 = (acc_hi >> 32) + (lo64 < acc_lo ? 1 : 0);
  return gl::reduce128(hi64, lo64);
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

__device__ __forceinline__ void full_round(uint64_t s[WIDTH], int r) {
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) s[j] = sbox(gl::add(s[j], RC[r * WIDTH + j]));
  mds_circ_diag(s);
}

__device__ __forceinline__ void partial_round(uint64_t s[WIDTH], int r) {
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) s[j] = gl::add(s[j], RC[r * WIDTH + j]);
  s[0] = sbox(s[0]);
  mds_circ_diag(s);
}

// Copy a constant set into this library's tables: rc holds the 360 round
// constants, circ/diag the MDS's circulant + diagonal decomposition (zeros
// where M has no such shape; only the 2d kernel reads them). Returns a
// cudaError_t code.
inline int set_constants(const uint64_t* rc, const uint32_t* circ,
                         const uint32_t* diag) {
  cudaError_t err = cudaMemcpyToSymbol(RC, rc, sizeof(RC));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(CIRC, circ, sizeof(CIRC));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(DIAG, diag, sizeof(DIAG));
  return static_cast<int>(err);
}

}  // namespace pos
