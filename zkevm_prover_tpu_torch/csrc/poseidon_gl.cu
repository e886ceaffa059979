// Poseidon-Goldilocks width-12 permutation over a batch of states (sm_90a).
//
// Replaces the TPU kernel zkevm_prover_tpu/ops/poseidon_pallas.py
// _make_kernel_mxu96 (the production "mxu96" mode of poseidon_pallas.permute).
// It computes the same function: 4 full, 22 partial and 4 full rounds of
// (add round constants, x^7 S-box on every lane or on lane 0, small-integer
// 12x12 MDS), with canonical output bit-identical to poseidon_gl.permute.
// The TPU kernel folds the batch onto sublanes as u32 lo/hi planes and runs
// the MDS as int8 matmuls on 7-bit limbs; none of that carries over here.
//
// Design: one thread per state, the 12 lanes in u64 registers, Goldilocks
// multiplies through __umul64hi (goldilocks.cuh), the rounds of
// poseidon_common.cuh, round constants and MDS coefficients in __constant__
// memory (every thread of a warp reads the same
// word, so each read is a broadcast). The MDS is a small-coefficient
// multiply-accumulate on the u32 halves of each lane, as _mds_small in
// ops/poseidon_gl.py does, then one 128-bit reduction per output lane.
// Partial rounds S-box lane 0 only.
//
// What bounds it on the H100: integer multiply throughput. A permutation is
// 118 S-boxes x 4 field multiplies (each two 64-bit multiplies, emulated by
// 32-bit IMADs, plus the reduction) and 30 MDS passes of 144 x 2 widening
// 32-bit multiply-adds, against 192 bytes of device-memory traffic (96 in,
// 96 out): thousands of integer operations per byte moved.
//
// Left for later: the sparse partial-round MDS factorisation, and fusing the
// Merkle row sponge and level hash so that digests stay on chip between
// permutations. (Staging the 96-byte rows through shared memory, the
// "blocked" mode's poseidon_gl_blocked.cu, measured slower on the H100.)
#include <cuda_runtime.h>

#include <cstdint>

#include "poseidon_common.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
permute_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
               int64_t n) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n) return;
  const uint64_t* src = in + i * pos::WIDTH;
  uint64_t s[pos::WIDTH];
#pragma unroll
  for (int j = 0; j < pos::WIDTH; ++j) s[j] = src[j];
  pos::permute_dense(s);
  uint64_t* dst = out + i * pos::WIDTH;
#pragma unroll
  for (int j = 0; j < pos::WIDTH; ++j) dst[j] = s[j];
}

}  // namespace

// Copy the constant set into __constant__ memory (pos::set_constants).
extern "C" int poseidon_gl_set_constants(const uint64_t* rc,
                                         const uint32_t* mds,
                                         const uint32_t* circ,
                                         const uint32_t* diag) {
  return pos::set_constants(rc, mds, circ, diag);
}

// out[i] = permute(in[i]) for n row-major (n, 12) uint64 states, launched on
// `stream`. Returns cudaGetLastError() after the launch.
extern "C" int poseidon_gl_permute(const uint64_t* in, uint64_t* out,
                                   long long n, void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + THREADS - 1) / THREADS;
  permute_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(in, out, n);
  return static_cast<int>(cudaGetLastError());
}
