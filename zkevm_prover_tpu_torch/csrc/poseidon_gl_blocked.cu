// Poseidon-Goldilocks permutation, shared-memory-staged tiles (sm_90a).
//
// Replaces the TPU kernel zkevm_prover_tpu/ops/poseidon_pallas.py
// _make_kernel_blocked (the "blocked" mode of poseidon_pallas.permute). That
// kernel folds the batch onto sublanes host-side, (12, B) -> (96, B/8), so
// every vector op fills a full (8, 128) tile with no relayout, and runs the
// MDS as 144 small-constant products on the VPU. Same function here, and the
// same aim, every lane busy with no relayout, reached the card's way.
//
// Design: a block of 128 threads owns a tile of 128 consecutive row-major
// (H, 12) states, 12 KiB. The block copies the tile into shared memory with
// 16-byte loads, neighbouring threads on neighbouring addresses (each load
// instruction of a warp moves 512 contiguous bytes), then each thread takes
// its own state out of shared memory into registers, permutes it (the dense
// MDS of poseidon_tables.cuh) and writes it back through shared memory, and
// the block stores the tile with 16-byte stores. A state sits at a stride
// of 13 u64 in shared memory, so the per-thread 8-byte reads and writes of
// one lane fall into distinct banks. The mxu96 kernel instead reads each
// state's 96 bytes straight from device memory per thread.
//
// What bounds it on the H100: integer multiply throughput (the dense MDS's
// widening multiply-adds and the canonical S-box); the staging only changes
// how the 192 bytes per state move. The wrapper pads the batch to the TPU
// kernel's multiple (8 x 2048 states), so the kernel has no ragged tile.
#include <cuda_runtime.h>

#include <cstdint>

#include "poseidon_tables.cuh"

namespace {

constexpr int THREADS = 128;          // states per tile, one per thread
constexpr int ROW = pos::WIDTH + 1;   // shared-memory stride of one state
constexpr int VEC = THREADS * pos::WIDTH / 2;  // 16-byte vectors per tile

__global__ void __launch_bounds__(THREADS)
permute_blocked_kernel(const uint64_t* __restrict__ in,
                       uint64_t* __restrict__ out) {
  __shared__ uint64_t tile[THREADS * ROW];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * THREADS * pos::WIDTH;
  const ulonglong2* src = reinterpret_cast<const ulonglong2*>(in + base);
  for (int v = threadIdx.x; v < VEC; v += THREADS) {
    ulonglong2 d = src[v];
    int e = 2 * v;                      // first u64 of the pair; 12 is even,
    int at = (e / pos::WIDTH) * ROW + e % pos::WIDTH;  // so both share a state
    tile[at] = d.x;
    tile[at + 1] = d.y;
  }
  __syncthreads();
  uint64_t s[pos::WIDTH];
#pragma unroll
  for (int j = 0; j < pos::WIDTH; ++j) s[j] = tile[threadIdx.x * ROW + j];
  pos::permute_dense(s);
#pragma unroll
  for (int j = 0; j < pos::WIDTH; ++j) tile[threadIdx.x * ROW + j] = s[j];
  __syncthreads();
  ulonglong2* dst = reinterpret_cast<ulonglong2*>(out + base);
  for (int v = threadIdx.x; v < VEC; v += THREADS) {
    int e = 2 * v;
    int at = (e / pos::WIDTH) * ROW + e % pos::WIDTH;
    dst[v] = make_ulonglong2(tile[at], tile[at + 1]);
  }
}

}  // namespace

// Copy the constant set into __constant__ memory (pos::set_constants).
extern "C" int poseidon_gl_blocked_set_constants(const uint64_t* rc,
                                                 const uint32_t* mds,
                                                 const uint32_t* circ,
                                                 const uint32_t* diag) {
  return pos::set_constants(rc, mds, circ, diag);
}

// out[i] = permute(in[i]) for n row-major (n, 12) uint64 states, n a
// multiple of 128, both 16-byte aligned, launched on `stream`. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a bad n).
extern "C" int poseidon_gl_blocked_permute(const uint64_t* in, uint64_t* out,
                                           long long n, void* stream) {
  if (n <= 0) return 0;
  if (n % THREADS) return static_cast<int>(cudaErrorInvalidValue);
  permute_blocked_kernel<<<static_cast<unsigned>(n / THREADS), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(in, out);
  return static_cast<int>(cudaGetLastError());
}
