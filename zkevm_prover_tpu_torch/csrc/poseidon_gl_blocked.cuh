// Poseidon-Goldilocks permutation, mode "blocked": row-major (H, 12) tiles
// staged through shared memory by the Tensor Memory Accelerator (sm_90a).
//
// Replaces the TPU kernel zkevm_prover_tpu/ops/poseidon_pallas.py
// _make_kernel_blocked (the "blocked" mode of poseidon_pallas.permute). That
// kernel folds the batch onto sublanes host-side, (12, B) -> (96, B/8), so
// every VPU op fills a full (8, 128) tile, and stages whole tiles through
// VMEM with no relayout. Same function here; the staging is the card's own.
//
// Design: a persistent grid (the SMs times the blocks that fit on one,
// from the occupancy API), each block walking tiles of 128 row-major states
// (12,288 bytes) with a stride of the grid. One thread moves every tile
// with 1-D bulk copies (cp.async.bulk, no tensor map): a load into a ring
// of kSlots shared-memory slots, each with its own mbarrier, so the next
// tile arrives while this one is permuted; a store straight from the slot
// once its states are done, waited on (bulk_group .read) before that slot
// takes its next load. Each thread takes its state from the slot, runs the
// lazy body of poseidon_lazy.cuh (kernel 1's) and writes the canonical
// state back to the slot. A ragged last tile of r states is a 96 r-byte
// copy, always a multiple of 16, so the kernel takes any H. A state sits at
// a 96-byte stride in the slot (the bulk copy cannot pad it); its 24
// shared-memory accesses per permutation are nothing beside the ~30,000
// instructions of the rounds.
//
// What bounds it on the H100: integer instruction throughput, as kernel 1
// (the same body, 192 bytes of device memory per permutation); the copies
// cost the threads no instructions but one thread's few per tile, and two
// block barriers per tile.
//
// Part of the poseidon_gl library: poseidon_gl.cu includes this file after
// poseidon_lazy.cuh.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "poseidon_lazy.cuh"

namespace {
namespace blocked {

constexpr int kStates = 128;  // states per tile, one per thread
constexpr int kSlots = 2;     // tiles in the shared-memory ring
constexpr int kStateBytes = WIDTH * 8;

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: `bytes` (a multiple of 16) from global `src` to shared `dst`,
// completing on the mbarrier `bar`, which expects them.
__device__ __forceinline__ void load_tile(uint64_t* dst, const uint64_t* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem(dst)), "l"(src), "r"(bytes), "r"(smem(bar)) : "memory");
}

// Wait for phase `parity` of the mbarrier `bar` to complete.
__device__ __forceinline__ void wait_tile(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done) : "r"(smem(bar)), "r"(parity) : "memory");
  } while (!done);
}

// One thread: `bytes` from shared `src` to global `dst`, as one bulk group.
__device__ __forceinline__ void store_tile(uint64_t* dst, const uint64_t* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(smem(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(kStates, 5)
permute_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
               int64_t n) {
  __shared__ __align__(128) uint64_t ring[kSlots][kStates * WIDTH];
  __shared__ __align__(8) uint64_t full[kSlots];
  const int t = threadIdx.x;
  const int64_t tiles = (n + kStates - 1) / kStates;
  const auto rows = [n](int64_t tile) {
    const int64_t left = n - tile * kStates;
    return static_cast<int>(left < kStates ? left : kStates);
  };
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < kSlots; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem(&full[i])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int64_t tile = blockIdx.x + static_cast<int64_t>(i) * gridDim.x;
      if (tile < tiles)
        load_tile(ring[i], in + tile * kStates * WIDTH,
                  rows(tile) * kStateBytes, &full[i]);
    }
  }
  __syncthreads();  // the barriers are initialised
  int k = 0;        // this block's tile count so far
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++k) {
    const int slot = k % kSlots;
    const int r = rows(tile);
    wait_tile(&full[slot], (k / kSlots) & 1);
    if (t < r) {
      ulonglong2* st = reinterpret_cast<ulonglong2*>(ring[slot] + t * WIDTH);
      uint64_t s[WIDTH];
#pragma unroll
      for (int j = 0; j < WIDTH / 2; ++j) {
        const ulonglong2 v = st[j];
        s[2 * j] = v.x;
        s[2 * j + 1] = v.y;
      }
      permute_lazy(s);
#pragma unroll
      for (int j = 0; j < WIDTH / 2; ++j)
        st[j] = make_ulonglong2(gl::canonical(s[2 * j]),
                                gl::canonical(s[2 * j + 1]));
      // these writes are read next by the bulk copy (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();  // the slot holds the tile's output
    if (t == 0) {
      store_tile(out + tile * kStates * WIDTH, ring[slot], r * kStateBytes);
      const int64_t next = tile + static_cast<int64_t>(kSlots) * gridDim.x;
      if (next < tiles) {
        // the store has read the slot: it may take the next load
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        load_tile(ring[slot], in + next * kStates * WIDTH,
                  rows(next) * kStateBytes, &full[slot]);
      }
    }
  }
  if (t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace blocked
}  // namespace

// out[i] = permute(in[i]) for n row-major (n, 12) uint64 states, any n,
// both 16-byte aligned, launched on `stream` as a persistent grid. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a pointer
// that is not 16-byte aligned).
extern "C" int poseidon_gl_blocked_permute(const uint64_t* in, uint64_t* out,
                                           long long n, void* stream) {
  if (n <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(in) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, blocked::permute_kernel, blocked::kStates, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (n + blocked::kStates - 1) / blocked::kStates;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const long long grid = tiles < resident ? tiles : resident;
  blocked::permute_kernel<<<static_cast<unsigned>(grid), blocked::kStates, 0,
                            static_cast<cudaStream_t>(stream)>>>(in, out, n);
  return static_cast<int>(cudaGetLastError());
}
