// Poseidon-Goldilocks permutation on a structure-of-arrays batch with the
// circulant + diagonal MDS, mode "2d" (sm_90a).
//
// Replaces the TPU kernel zkevm_prover_tpu/ops/poseidon_pallas.py
// _make_kernel_2d (mode "2d" of poseidon_pallas.permute). It holds the batch
// as (12, TB=512) lane-major row vectors, treats the state as one (12, TB)
// tile, runs the rounds in lax.fori_loop with a rolled one-hot constant
// select and applies the circulant + diagonal decomposition of the MDS
// (_circ_diag): out_i = sum_k circ_k s_((i+k)%12) + diag_i s_i.
//
// Design: the batch stays in the (12, B) layout, so lane j of state i is at
// j * B + i; one thread per state reads its 12 lanes with loads that are
// coalesced across the warp (32 neighbouring states per lane), with no
// shared memory. The rounds run in three rolled loops (#pragma unroll 1),
// as fori_loop does, with the round's constants read from __constant__
// memory at a runtime index (uniform across the warp: a broadcast), and the
// MDS as 12 + 1 terms per output lane from CIRC and DIAG
// (poseidon_tables.cuh).
//
// What bounds it on the H100: integer multiply throughput, as for the
// other modes (the same 118 S-boxes per state, canonical here); the rolled
// loops trade instruction-cache footprint and register pressure for a loop
// counter. The wrapper pads the batch to the TPU kernel's tile (512 states).
#include <cuda_runtime.h>

#include <cstdint>

#include "poseidon_tables.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
permute_soa_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                   int64_t b) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= b) return;
  uint64_t s[pos::WIDTH];
#pragma unroll
  for (int j = 0; j < pos::WIDTH; ++j) s[j] = gl::canonical(in[j * b + i]);
#pragma unroll 1
  for (int r = 0; r < pos::HALF_F; ++r) pos::full_round(s, r);
#pragma unroll 1
  for (int r = pos::HALF_F; r < pos::HALF_F + pos::ROUNDS_P; ++r)
    pos::partial_round(s, r);
#pragma unroll 1
  for (int r = pos::HALF_F + pos::ROUNDS_P; r < pos::N_ROUNDS; ++r)
    pos::full_round(s, r);
#pragma unroll
  for (int j = 0; j < pos::WIDTH; ++j) out[j * b + i] = s[j];
}

}  // namespace

// Copy the constant set into __constant__ memory (pos::set_constants).
extern "C" int poseidon_gl_soa_set_constants(const uint64_t* rc,
                                             const uint32_t* circ,
                                             const uint32_t* diag) {
  return pos::set_constants(rc, circ, diag);
}

// out[:, i] = permute(in[:, i]) for a (12, b) uint64 lane-major batch with
// the circulant + diagonal MDS, launched on `stream`. Returns
// cudaGetLastError() after the launch.
extern "C" int poseidon_gl_soa_permute(const uint64_t* in, uint64_t* out,
                                       long long b, void* stream) {
  if (b <= 0) return 0;
  unsigned blocks = static_cast<unsigned>((b + THREADS - 1) / THREADS);
  permute_soa_kernel<<<blocks, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(in, out, b);
  return static_cast<int>(cudaGetLastError());
}
