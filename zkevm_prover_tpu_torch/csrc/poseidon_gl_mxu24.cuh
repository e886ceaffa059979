// Poseidon-Goldilocks permutation, mode "mxu24": the full rounds' MDS on the
// tensor cores as byte-plane PAIRS, in mma.sync fragments that stay in
// registers (sm_90a).
//
// Replaces the TPU kernel zkevm_prover_tpu/ops/poseidon_pallas.py
// _make_kernel_mxu24 (mode "mxu24" of poseidon_pallas.permute). That kernel
// stacks two batch halves as (24, B) to fill the TPU's 8-sublane tiles and
// runs each round's MDS as one MXU matmul against I_8 (x) blockdiag(M, M)
// over the byte planes, two adjacent planes side by side, pairing their
// products carry-free (G_q = R_2q + R_2q+1 2^8) before the recombination.
// The pairing carries over; the stacking has no meaning on this card and
// goes.
//
// Design: mode mxu's (poseidon_gl_mxu.cuh), whose kernel body, layout
// changes and recombination this file reuses; only the full round differs.
//  - A warp owns 32 states of the (H, 12) row-major batch; lane (g, t)
//    holds lanes 3t..3t+2 of states g, g+8, g+16 and g+24, loaded straight
//    from the batch (a ragged last warp loads zeros and stores nothing).
//  - Full rounds (8), two byte planes side by side in k: for each m16 tile
//    and each plane pair q (0..3) the A fragment is four words, a0 and a1
//    rows g and g+8 at k-slots 4t..4t+2 for plane 2q, a2 and a3 the same
//    rows at k-slots 16+4t..16+4t+2 for plane 2q+1 (the PTX ISA's
//    m16n8k32 A layout puts a2 and a3 at k 16..31; slots 4t+3 and
//    16+4t+3 meet zero rows of B). B is blockdiag(M^T, M^T) with its rows
//    and columns permuted (poseidon_cuda.mma_operands, MXU24_K_LANE and
//    MXU24_N_LANE, in MXU24_B): in n8 tile c, column 2u is output lane
//    3u + c of the even plane and column 2u + 1 the same lane of the odd
//    plane, so the C fragment of tile c hands lane (g, t) R_2q (c0, c2)
//    and R_2q+1 (c1, c3) of output lane 3t + c for rows g and g + 8, and
//    the carry-free pair is formed in registers. Per round and warp:
//    4 pairs x 3 n8 tiles x 2 m16 tiles = 24 MMAs (mxu: 32), 6 per
//    permutation, 37.5 % of their multiply-adds useful (mxu: 28.1 %);
//    every B column is used. u8 x u8 -> s32 is exact on full bytes (the
//    TPU's int8 path takes 7-bit planes only because its int8 is signed):
//    every product sum is < 255 * 264 < 2^17 and every pair < 2^25. The
//    pairs join in two 64-bit halves and one 3-word sum with the FOLD
//    constant, reduced once (mxu::recombine). One m16 tile per trip of a
//    rolled loop, the rows rotated between trips, as mxu::full_round: both
//    tiles at once measured 7 % slower on the H100 (PERF.md).
//  - Partial rounds (22): mxu's, one state per lane through the warp's
//    shared tile (mxu::to_rows, mxu::to_fragments) and poseidon_lazy.cuh
//    partial_rounds, the six B words parked in shared memory meanwhile.
//
// What bounds it on the H100: integer instruction throughput, as mxu: the
// S-boxes and the sparse partial rounds are kernel 1's instructions, and
// the full round's MDS is byte packing (PRMT), 24 MMAs and the
// recombination per warp. No shared memory and no barrier in the full
// round. 92 registers at 5 blocks of 128 threads per SM, no spill; with its
// B words held in registers through the partial rounds it spilled there and
// ran 5 % slower, and at 4 blocks (98 registers) 5 % slower too.
//
// Part of the poseidon_gl library: poseidon_gl.cu includes this file after
// poseidon_gl_mxu.cuh.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "poseidon_gl_mxu.cuh"

namespace {
namespace mxu24 {

using mxu::kCols;
using mxu::kRows;

constexpr int kK = 32;      // the MMA's k: two planes of 16 slots
constexpr int kTiles = 3;   // n8 tiles: output lanes 3u + c, c = tile
constexpr int kN = 8 * kTiles;

// B = blockdiag(M^T, M^T), k-slot 16e + 4t + c = input lane 3t + c of
// plane parity e, column 8c' + 2u + e = output lane 3u + c' of parity e:
// (32, 24) u8 row-major (row = k), poseidon_cuda.mma_operands.
__constant__ uint8_t MXU24_B[kK * kN];

// d = a b over one m16n8k32 u8 tile.
__device__ __forceinline__ void mma(uint32_t (&d)[4], uint32_t a0,
                                    uint32_t a1, uint32_t a2, uint32_t a3,
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "r"(0u));
}

// Planes 4h + 2q (even) and 4h + 2q + 1 (odd) of x0, x1, x2, each in bytes
// 0..2 of a word, in three PRMTs: the two planes of x0 and x1 first, then
// x2's byte on each. Byte 3 of both is x0's even byte and meets a zero row
// of B.
__device__ __forceinline__ void pack_pair(uint64_t x0, uint64_t x1,
                                          uint64_t x2, int h, int q,
                                          uint32_t& even, uint32_t& odd) {
  const uint32_t w0 = h ? gl::hi32(x0) : gl::lo32(x0);
  const uint32_t w1 = h ? gl::hi32(x1) : gl::lo32(x1);
  const uint32_t w2 = h ? gl::hi32(x2) : gl::lo32(x2);
  const int e = 2 * q;   // the even plane's byte in the words
  // x0.e, x1.e, x0.e+1, x1.e+1
  const uint32_t b01 = __byte_perm(
      w0, w1, e | ((4 + e) << 4) | ((e + 1) << 8) | ((5 + e) << 12));
  even = __byte_perm(b01, w2, 0x10 | ((4 + e) << 8));
  odd = __byte_perm(b01, w2, 0x32 | ((5 + e) << 8));
}

// Mode mxu24's B fragments and its full round.
struct Fragments {
  // column g of n8 tile c: k-slots 4t..4t+3 (b[2c], the even plane) and
  // 16+4t..16+4t+3 (b[2c + 1], the odd plane)
  static constexpr int kWords = 2 * kTiles;
  uint32_t b[kWords] = {};
  __device__ Fragments(int g, int t) {
#pragma unroll
    for (int c = 0; c < kTiles; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          b[2 * c + e] |=
              uint32_t{MXU24_B[(16 * e + 4 * t + k) * kN + 8 * c + g]}
              << (8 * k);
  }

  // One full round in fragment layout: v[m][c] is lane 3t + c of state
  // g + 8m. One m16 tile at a time, in a rolled loop of two trips: the tile
  // in rows 0 and 1, then the rows rotate to bring the other tile there.
  __device__ __forceinline__ void full_round(uint64_t (&v)[kRows][kCols],
                                             int r, int t) const {
    const uint64_t* fold = FOLD + r * WIDTH + kCols * t;
#pragma unroll 1
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int c = 0; c < kCols; ++c) v[m][c] = pos::sbox_lazy(v[m][c]);
      // half[h][row][c] = G_2h + G_2h+1 2^16 (pair 2h + q in trip q)
      uint64_t half[2][2][kCols];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          uint32_t a[2][2];   // [row][plane parity]
#pragma unroll
          for (int row = 0; row < 2; ++row)
            pack_pair(v[row][0], v[row][1], v[row][2], h, q, a[row][0],
                      a[row][1]);
#pragma unroll
          for (int c = 0; c < kTiles; ++c) {
            uint32_t d[4];
            mma(d, a[0][0], a[1][0], a[0][1], a[1][1], b[2 * c],
                b[2 * c + 1]);
            // G = R_even + R_odd 2^8 of lane 3t + c, rows g and g + 8
#pragma unroll
            for (int row = 0; row < 2; ++row) {
              const uint64_t pair = d[2 * row] + (d[2 * row + 1] << 8);
              if (q == 0) {
                half[h][row][c] = pair;
              } else {
                half[h][row][c] += pair << 16;
              }
            }
          }
        }
      }
#pragma unroll
      for (int row = 0; row < 2; ++row)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          v[row][c] = mxu::recombine(fold[c], half[0][row][c],
                                     half[1][row][c]);
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
};

}  // namespace mxu24
}  // namespace

// out[i] = permute(in[i]) for n row-major (n, 12) uint64 states, any n,
// launched on `stream`. Returns cudaGetLastError() after the launch.
extern "C" int poseidon_gl_mxu24_permute(const uint64_t* in, uint64_t* out,
                                         long long n, void* stream) {
  return mxu::launch<mxu24::Fragments>(in, out, n, stream);
}
