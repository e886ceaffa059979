// Poseidon-Goldilocks permutation, mode "1d": a (12, B) lane-major batch
// (sm_90a).
//
// Replaces the TPU kernel zkevm_prover_tpu/ops/poseidon_pallas.py
// _make_kernel (mode "1d" of poseidon_pallas.permute). That kernel holds
// the batch as (12, TB=512) lane-major row vectors and runs the rounds in
// lax.fori_loop with a rolled one-hot constant select and the MDS as 144
// small-constant products over the 12 row vectors. Same function and the
// same layout here.
//
// Design: lane j of state i is at j * B + i; one thread per state reads its
// 12 lanes straight into registers, each load coalesced across the warp (32
// neighbouring states of one lane), and writes them back the same way: 192
// bytes per permutation, so no shared memory and no async copies. The
// rounds are the lazy body of poseidon_lazy.cuh (kernel 1's): folded
// constants, the sparse partial rounds, one full-round loop body. The
// kernel bounds-checks, so it takes any B.
//
// What bounds it on the H100: integer instruction throughput, as kernel 1
// (about 30,000 instructions per permutation). The (H, 12) <-> (12, H)
// transposes around it are the wrapper's (poseidon_cuda.permute_1d), the
// layout this mode takes.
//
// Part of the poseidon_gl library: poseidon_gl.cu includes this file after
// poseidon_lazy.cuh.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "poseidon_lazy.cuh"

namespace {
namespace lane_major {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads, 5)
permute_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
               int64_t b) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= b) return;
  uint64_t s[WIDTH];
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) s[j] = in[j * b + i];
  permute_lazy(s);
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) out[j * b + i] = gl::canonical(s[j]);
}

}  // namespace lane_major
}  // namespace

// out[:, i] = permute(in[:, i]) for a (12, b) uint64 lane-major batch, any
// b, launched on `stream`. Returns cudaGetLastError() after the launch.
extern "C" int poseidon_gl_1d_permute(const uint64_t* in, uint64_t* out,
                                      long long b, void* stream) {
  if (b <= 0) return 0;
  const long long blocks =
      (b + lane_major::kThreads - 1) / lane_major::kThreads;
  lane_major::permute_kernel<<<static_cast<unsigned>(blocks),
                               lane_major::kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(in, out, b);
  return static_cast<int>(cudaGetLastError());
}
