// Poseidon-Goldilocks permutation, mode "mxu": the full rounds' MDS on the
// tensor cores, in mma.sync fragments that stay in registers (sm_90a).
//
// Replaces the TPU kernel zkevm_prover_tpu/ops/poseidon_pallas.py
// _make_kernel_mxu (mode "mxu" of poseidon_pallas.permute). That kernel
// computes each round's linear layer M s as one bf16 MXU matmul over the 8
// byte planes of the state (A = I_8 (x) M, every product exact), and
// recombines sum_t R_t 2^(8t) on the VPU with the next round's constant in
// the accumulator's seed. Same arithmetic here, laid out for the card.
//
// Design: a warp owns 32 states of the (H, 12) row-major batch.
//  - Full rounds (8), in the fragment layout of mma.sync.m16n8k32 (u8 x u8
//    -> s32): the warp's states are two m16 tiles of A = states x k-slots.
//    Lane (g = lane / 4, t = lane % 4) holds lanes 3t..3t+2 of states g,
//    g+8, g+16 and g+24 (12 u64, loaded straight from the batch), runs the
//    lazy S-box on them, and for each byte plane packs its bytes into its A
//    fragment: k-slots 4t..4t+2 (the PTX ISA's A layout gives the lane
//    k-slots 4t..4t+3 of rows g and g+8; slot 4t+3 and k 16..31 meet zero
//    rows of B). B = M^T with permuted columns (poseidon_cuda.mma_operands,
//    in MXU_B): column 2t and 2t+1 of n8 tile 0 are output lanes 3t and
//    3t+1, column 2t of tile 1 is lane 3t+2, so the C fragment (rows g and
//    g+8, columns 2t and 2t+1) hands each lane the products of exactly the
//    lanes it holds: no shared memory and no barrier in the round. Per
//    round and warp: 8 planes x 2 m16 tiles x 2 n8 tiles = 32 MMAs, one per
//    state, one m16 tile after the other in a rolled loop (full_round).
//    Every product sum is < 255 * 264 < 2^17; planes pair carry-free
//    (R_2q + R_2q+1 2^8 < 2^26), the pairs join in two 64-bit halves, and
//    each output lane is one 3-word sum with its FOLD constant (< 2^74),
//    reduced once (reduce96).
//  - Partial rounds (22), one state per thread: lane 0 of every state lives
//    on the t = 0 lanes in fragment layout, so a partial round's one S-box
//    would run four states deep on 8 of 32 lanes. The warp changes layout
//    through a 3 KB shared tile after round 3 and back before round 26 (two
//    trips per permutation) and runs poseidon_lazy.cuh partial_rounds in
//    between, unchanged.
// The batch is read and written in fragment layout (24-byte runs, 8-byte
// loads), states past the end of a ragged last warp as zeros, never
// stored: mma.sync needs all 32 lanes.
//
// What bounds it on the H100: integer instruction throughput, as kernel 1:
// the S-boxes and the sparse partial rounds are the same instructions; the
// full rounds' MDS becomes byte packing (PRMT), 32 MMAs and the
// recombination per warp, against kernel 1's 432 IMADs per state. The
// tensor cores' share of the work is small (8 MMAs per permutation); the
// registers are the constraint: 5 blocks of 128 threads per SM, as kernel
// 1, cap them at 96 (65,536 per SM, allocated 8 per thread at a time). With
// the B fragments parked through the partial rounds mxu takes 96 and mxu24
// 92, neither spilling; kept in registers there, mxu24's spilled and ran
// 5 % slower (PERF.md).
//
// Mode mxu24 (poseidon_gl_mxu24.cuh) runs this kernel body with its own
// full round: permute_kernel is a template on the lane's B fragments and
// the full round they serve.
//
// Part of the poseidon_gl library: poseidon_gl.cu includes this file after
// poseidon_lazy.cuh.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "poseidon_lazy.cuh"

namespace {
namespace mxu {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 4;    // states of a lane in fragment layout
constexpr int kCols = 3;    // lanes of each of them
constexpr int kK = 32;      // the MMA's k
constexpr int kN = 16;      // two n8 tiles

// B = M^T, k-slot 4t + c = input lane 3t + c, columns permuted as above:
// (32, 16) u8 row-major (row = k), poseidon_cuda.mma_operands.
__constant__ uint8_t MXU_B[kK * kN];

// d = a b over one m16n8k32 u8 tile: a = {a0, a1, 0, 0} (k 16..31 zero),
// b = {b0, 0}.
__device__ __forceinline__ void mma(uint32_t (&d)[4], uint32_t a0,
                                    uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %7, %7}, {%6, %7}, {%7, %7, %7, %7};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "r"(0u));
}

// Byte p of x0, x1, x2 in bytes 0..2 of a word; byte 3 (k-slot 4t + 3)
// repeats byte 0 and meets a zero row of B.
__device__ __forceinline__ uint32_t pack3(uint64_t x0, uint64_t x1,
                                          uint64_t x2, int p) {
  const int q = p & 3;
  const uint32_t w0 = p < 4 ? gl::lo32(x0) : gl::hi32(x0);
  const uint32_t w1 = p < 4 ? gl::lo32(x1) : gl::hi32(x1);
  const uint32_t w2 = p < 4 ? gl::lo32(x2) : gl::hi32(x2);
  const uint32_t b = __byte_perm(w0, w1, q | ((4 + q) << 4));
  return __byte_perm(b, w2, 0x10 | ((4 + q) << 8));
}

// k + lo + hi * 2^32 (lo, hi < 2^42) as (w2:w1:w0), reduced once, lazy.
__device__ __forceinline__ uint64_t recombine(uint64_t k, uint64_t lo,
                                              uint64_t hi) {
  uint32_t w0, w1, w2;
  asm("add.cc.u32  %0, %3, %5;\n\t"
      "addc.cc.u32 %1, %4, %6;\n\t"
      "addc.u32    %2, %8, %9;\n\t"
      "add.cc.u32  %1, %1, %7;\n\t"
      "addc.u32    %2, %2, %9;\n\t"
      : "=&r"(w0), "=&r"(w1), "=&r"(w2)
      : "r"(gl::lo32(k)), "r"(gl::hi32(k)), "r"(gl::lo32(lo)),
        "r"(gl::hi32(lo)), "r"(gl::lo32(hi)), "r"(gl::hi32(hi)), "r"(0u));
  return pos::reduce96(w0, w1, w2);
}

// One full round in fragment layout: v[m][c] is lane 3t + c of state
// g + 8m; b0, b1 the lane's B fragments of the two n8 tiles. One m16 tile
// at a time, in a rolled loop of two trips: the tile in rows 0 and 1 (its
// A fragments read only its own states, so they take their new values as
// soon as its products are in), then the rows rotate to bring the other
// tile there. Both tiles at once spilled at the 5-block register cap; the
// rolled loop measured 6.8 % faster on the H100 (PERF.md).
__device__ __forceinline__ void full_round(uint64_t (&v)[kRows][kCols],
                                           uint32_t b0, uint32_t b1, int r,
                                           int t) {
  const uint64_t* fold = FOLD + r * WIDTH + kCols * t;
#pragma unroll 1
  for (int mt = 0; mt < 2; ++mt) {
    const int m0 = 0, m1 = 1;   // rows g, g + 8 of the tile in rows 0, 1
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int c = 0; c < kCols; ++c) v[m][c] = pos::sbox_lazy(v[m][c]);
    // half[h][row][c] = sum over planes 4h..4h+3 of R_p 2^(8(p - 4h))
    uint64_t half[2][2][kCols];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t pair[2][2][kCols];   // R_2q + R_2q+1 2^8
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = 4 * h + 2 * q + e;
          const uint32_t a0 = pack3(v[m0][0], v[m0][1], v[m0][2], p);
          const uint32_t a1 = pack3(v[m1][0], v[m1][1], v[m1][2], p);
          uint32_t d0[4], d1[4];
          mma(d0, a0, a1, b0);   // lanes 3t, 3t + 1
          mma(d1, a0, a1, b1);   // lane 3t + 2 (odd columns are zero)
          const uint32_t got[2][kCols] = {{d0[0], d0[1], d1[0]},
                                          {d0[2], d0[3], d1[2]}};
#pragma unroll
          for (int row = 0; row < 2; ++row)
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              uint32_t& w = pair[q][row][c];
              if (e == 0) {
                w = got[row][c];
              } else {
                w += got[row][c] << 8;
              }
            }
        }
      }
#pragma unroll
      for (int row = 0; row < 2; ++row)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          half[h][row][c] = static_cast<uint64_t>(pair[0][row][c]) +
                            (static_cast<uint64_t>(pair[1][row][c]) << 16);
    }
#pragma unroll
    for (int row = 0; row < 2; ++row)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        v[m0 + row][c] = recombine(fold[c], half[0][row][c], half[1][row][c]);
    // the other tile's rows to 0 and 1
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const uint64_t x0 = v[0][c], x1 = v[1][c];
      v[0][c] = v[2][c];
      v[1][c] = v[3][c];
      v[2][c] = x0;
      v[3][c] = x1;
    }
  }
}

// Fragment layout -> one state per lane (state `lane` of the warp) through
// the warp's (32, 12) shared tile, and back.
__device__ __forceinline__ void to_rows(const uint64_t (&v)[kRows][kCols],
                                        uint64_t s[WIDTH], uint64_t* tile,
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      tile[(g + 8 * m) * WIDTH + kCols * t + c] = v[m][c];
  __syncwarp();
  const ulonglong2* row = reinterpret_cast<const ulonglong2*>(tile +
                                                              lane * WIDTH);
#pragma unroll
  for (int j = 0; j < WIDTH / 2; ++j) {
    const ulonglong2 x = row[j];
    s[2 * j] = x.x;
    s[2 * j + 1] = x.y;
  }
  __syncwarp();
}

__device__ __forceinline__ void to_fragments(const uint64_t s[WIDTH],
                                             uint64_t (&v)[kRows][kCols],
                                             uint64_t* tile, int lane) {
  const int g = lane >> 2, t = lane & 3;
  ulonglong2* row = reinterpret_cast<ulonglong2*>(tile + lane * WIDTH);
#pragma unroll
  for (int j = 0; j < WIDTH / 2; ++j)
    row[j] = make_ulonglong2(s[2 * j], s[2 * j + 1]);
  __syncwarp();
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      v[m][c] = tile[(g + 8 * m) * WIDTH + kCols * t + c];
  __syncwarp();
}

// Mode mxu's B fragments (column g of each n8 tile, k-slots 4t..4t+3) and
// its full round.
struct Fragments {
  static constexpr int kWords = 2;
  uint32_t b[kWords] = {};
  __device__ Fragments(int g, int t) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        b[nt] |= uint32_t{MXU_B[(4 * t + c) * kN + 8 * nt + g]} << (8 * c);
  }
  __device__ __forceinline__ void full_round(uint64_t (&v)[kRows][kCols],
                                             int r, int t) const {
    mxu::full_round(v, b[0], b[1], r, t);
  }
};

// The kernel of the fragment-layout modes: Frag holds the lane's B
// fragments (its kWords words b) and runs a full round in fragment layout
// (mxu: Fragments; mxu24: mxu24::Fragments, poseidon_gl_mxu24.cuh); loads,
// stores and the partial rounds are shared. The B fragments wait in shared
// memory through the partial rounds, which do not use them, so that their
// registers serve the partial rounds.
template <class Frag>
__global__ void __launch_bounds__(kThreads, 5)
permute_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
               int64_t n) {
  __shared__ __align__(16) uint64_t tiles[kWarps][32 * WIDTH];
  __shared__ uint32_t parked[kWarps][32 * Frag::kWords];
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int warp = threadIdx.x >> 5;
  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * 32;
  if (base >= n) return;   // the whole warp is past the batch
  uint64_t* tile = tiles[warp];
  Frag frag(g, t);
  uint64_t v[kRows][kCols];
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const int64_t i = base + g + 8 * m;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const uint64_t x = i < n ? in[i * WIDTH + kCols * t + c] : 0;
      v[m][c] = gl::add_lazy(x, RC0[kCols * t + c]);
    }
  }
#pragma unroll 1
  for (int r = 0; r < pos::N_ROUNDS;) {
    frag.full_round(v, r, t);
    if (++r == pos::HALF_F) {
#pragma unroll
      for (int k = 0; k < Frag::kWords; ++k)
        parked[warp][32 * k + lane] = frag.b[k];
      uint64_t s[WIDTH];
      to_rows(v, s, tile, lane);
      partial_rounds(s);
      to_fragments(s, v, tile, lane);
#pragma unroll
      for (int k = 0; k < Frag::kWords; ++k)
        frag.b[k] = parked[warp][32 * k + lane];
      r += pos::ROUNDS_P;
    }
  }
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const int64_t i = base + g + 8 * m;
    if (i < n) {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        out[i * WIDTH + kCols * t + c] = gl::canonical(v[m][c]);
    }
  }
}

// One launch of permute_kernel<Frag> over n states on `stream`. Returns
// cudaGetLastError() after the launch.
template <class Frag>
int launch(const uint64_t* in, uint64_t* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const long long per_block = 32LL * kWarps;
  const long long blocks = (n + per_block - 1) / per_block;
  permute_kernel<Frag><<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(in, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mxu
}  // namespace

// out[i] = permute(in[i]) for n row-major (n, 12) uint64 states, any n,
// launched on `stream`. Returns cudaGetLastError() after the launch.
extern "C" int poseidon_gl_mxu_permute(const uint64_t* in, uint64_t* out,
                                       long long n, void* stream) {
  return mxu::launch<mxu::Fragments>(in, out, n, stream);
}
