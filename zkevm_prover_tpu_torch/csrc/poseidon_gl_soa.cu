// Poseidon-Goldilocks permutation on a structure-of-arrays batch (sm_90a).
//
// Replaces the TPU kernels zkevm_prover_tpu/ops/poseidon_pallas.py
// _make_kernel (mode "1d") and _make_kernel_2d (mode "2d"), both launched by
// the pallas_call of the "1d"/"2d" path. They hold the batch as (12, TB=512)
// lane-major row vectors and run the rounds in lax.fori_loop with a rolled
// one-hot constant select. "1d" applies the MDS as 144 small-constant
// products over 12 row vectors; "2d" treats the state as one (12, TB) tile
// and applies the circulant + diagonal decomposition of the MDS
// (_circ_diag): out_i = sum_k circ_k s_((i+k)%12) + diag_i s_i.
//
// Design: the batch stays in the (12, B) layout, so lane j of state i is at
// j * B + i; one thread per state reads its 12 lanes with loads that are
// coalesced across the warp (32 neighbouring states per lane), with no
// shared memory. The rounds run in three rolled loops (#pragma unroll 1),
// as fori_loop does, with the round's constants read from __constant__
// memory at a runtime index (uniform across the warp: a broadcast). The MDS
// form is the template parameter: kDense for "1d", kCircDiag for "2d"
// (12 + 1 terms per output lane, constants from CIRC and DIAG).
//
// What bounds it on the H100: integer multiply throughput, as for the
// other modes (the same 118 S-boxes per state); the rolled loops trade
// instruction-cache footprint and register pressure for a loop counter.
// The wrapper pads the batch to the TPU kernel's tile (512 states).
#include <cuda_runtime.h>

#include <cstdint>

#include "poseidon_common.cuh"

namespace {

constexpr int THREADS = 128;

template <pos::Mds kMds>
__global__ void __launch_bounds__(THREADS)
permute_soa_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                   int64_t b) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= b) return;
  uint64_t s[pos::WIDTH];
#pragma unroll
  for (int j = 0; j < pos::WIDTH; ++j) s[j] = gl::canonical(in[j * b + i]);
#pragma unroll 1
  for (int r = 0; r < pos::HALF_F; ++r) pos::full_round<kMds>(s, r);
#pragma unroll 1
  for (int r = pos::HALF_F; r < pos::HALF_F + pos::ROUNDS_P; ++r)
    pos::partial_round<kMds>(s, r);
#pragma unroll 1
  for (int r = pos::HALF_F + pos::ROUNDS_P; r < pos::N_ROUNDS; ++r)
    pos::full_round<kMds>(s, r);
#pragma unroll
  for (int j = 0; j < pos::WIDTH; ++j) out[j * b + i] = s[j];
}

}  // namespace

// Copy the constant set into __constant__ memory (pos::set_constants).
extern "C" int poseidon_gl_soa_set_constants(const uint64_t* rc,
                                             const uint32_t* mds,
                                             const uint32_t* circ,
                                             const uint32_t* diag) {
  return pos::set_constants(rc, mds, circ, diag);
}

// out[:, i] = permute(in[:, i]) for a (12, b) uint64 lane-major batch,
// launched on `stream`; circ_diag selects the "2d" MDS form (it needs the
// circulant + diagonal tables). Returns cudaGetLastError() after the launch.
extern "C" int poseidon_gl_soa_permute(const uint64_t* in, uint64_t* out,
                                       long long b, int circ_diag,
                                       void* stream) {
  if (b <= 0) return 0;
  unsigned blocks = static_cast<unsigned>((b + THREADS - 1) / THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (circ_diag) {
    permute_soa_kernel<pos::Mds::kCircDiag><<<blocks, THREADS, 0, st>>>(
        in, out, b);
  } else {
    permute_soa_kernel<pos::Mds::kDense><<<blocks, THREADS, 0, st>>>(in, out,
                                                                      b);
  }
  return static_cast<int>(cudaGetLastError());
}
