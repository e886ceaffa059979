// The lazy Poseidon-Goldilocks permutation body: one thread, one state in
// 12 u64 registers, any u64 in and out (canonical once, by the caller).
//
// One copy of it serves every kernel of the poseidon_gl library
// (poseidon_gl.cu: the mxu96 permutation and the fused Merkle commit;
// poseidon_gl_2d.cuh, poseidon_gl_mxu.cuh, poseidon_gl_mxu24.cuh,
// poseidon_gl_blocked.cuh, poseidon_gl_1d.cuh), which are one translation
// unit: poseidon_gl.cu includes this header and the other five, so the
// constant tables below exist once and poseidon_gl_set_constants fills
// them for all of them. The schedule:
//  - RC0 added before round 0; FOLD[r] added inside round r's MDS reduction
//    (poseidon_cuda.fold_constants: every partial round's constants but
//    lane 0's pushed forward into the first full round after them);
//  - the full rounds' MDS with the reference coefficients compiled in as
//    immediates on 22/21/21-bit limbs (poseidon_common.cuh mds_fold_limbs;
//    a kernel may pass another form of the same matrix as `Mds`, as 2d
//    does; mxu and mxu24 run the full rounds in their own layout and take
//    only the partial rounds from here);
//  - the 22 partial rounds' MDS factored sparse (the Poseidon paper's
//    appendix B; poseidon_cuda.sparse_constants: SP_PRE, SP_W, SP_V);
//  - one rolled loop body for all eight full rounds (unrolled copies ran
//    slower: instruction fetch).
#pragma once

#include <cstdint>

#include "poseidon_common.cuh"

namespace {

using pos::WIDTH;

__constant__ uint64_t RC0[WIDTH];                 // added before round 0
__constant__ uint64_t FOLD[pos::N_ROUNDS * WIDTH];  // added after round r
// the sparse partial rounds (poseidon_cuda.sparse_constants)
constexpr int kHat = WIDTH - 1;
__constant__ uint64_t SP_PRE[kHat * kHat];        // lanes 1..11, round 3
__constant__ uint64_t SP_W[pos::ROUNDS_P * kHat];  // row 0, lanes 1..11
__constant__ uint64_t SP_V[pos::ROUNDS_P * kHat];  // column 0, lanes 1..11

// The full rounds' MDS of kernel 1: the dense coefficients as immediates.
struct DenseMds {
  __device__ __forceinline__ void operator()(uint64_t s[WIDTH],
                                             const uint64_t* c) const {
    pos::mds_fold_limbs(s, c);
  }
};

template <class Mds>
__device__ __forceinline__ void full_round(uint64_t s[WIDTH], int r) {
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) s[j] = pos::sbox_lazy(s[j]);
  Mds()(s, FOLD + r * WIDTH);
}

// The 22 partial rounds, their MDS factored sparse (poseidon_cuda
// .sparse_constants): lanes 1..11 <- PRE lanes 1..11 (the dense factors of
// all 22 rounds, moved onto the last full round), then per round
// [[m00, w], [v, I]]: lane 0 <- m00 x + w . s[1..11] + its constant, lane
// j <- s[j] + v_j x, x the S-boxed lane 0. Lane 0's sum is one 5-word
// accumulator reduced once; the dense small-integer MDS here measured
// slower (27 % more IMADs per permutation).
__device__ __forceinline__ void partial_rounds(uint64_t s[WIDTH]) {
  uint64_t t[kHat];
#pragma unroll
  for (int i = 0; i < kHat; ++i) {
    uint32_t r[5] = {0, 0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < kHat; ++j)
      gl::mul_acc(r, SP_PRE[i * kHat + j], s[1 + j]);
    t[i] = gl::reduce_words(r[0], r[1], r[2], r[3], r[4]);
  }
#pragma unroll
  for (int i = 0; i < kHat; ++i) s[1 + i] = t[i];
#pragma unroll 1
  for (int k = 0; k < pos::ROUNDS_P; ++k) {
    const uint64_t x = pos::sbox_lazy(s[0]);
    const uint64_t c = FOLD[(pos::HALF_F + k) * WIDTH];
    uint32_t r[5] = {gl::lo32(c), gl::hi32(c), 0, 0, 0};
    gl::mul_acc(r, pos::mds_coeff(0, 0), x);
#pragma unroll
    for (int j = 0; j < kHat; ++j)
      gl::mul_acc(r, SP_W[k * kHat + j], s[1 + j]);
#pragma unroll
    for (int j = 0; j < kHat; ++j)
      s[1 + j] = gl::mul_add_lazy(SP_V[k * kHat + j], x, s[1 + j]);
    s[0] = gl::reduce_words(r[0], r[1], r[2], r[3], r[4]);
  }
  // the rest of the last partial round's constants (for lanes 1..11)
  constexpr int kLast = pos::HALF_F + pos::ROUNDS_P - 1;
#pragma unroll
  for (int j = 1; j < WIDTH; ++j)
    s[j] = gl::add_lazy(s[j], FOLD[kLast * WIDTH + j]);
}

// The permutation of one lazy state, left lazy; Mds(s, c) sets s <- M s + c
// for the full rounds.
template <class Mds = DenseMds>
__device__ __forceinline__ void permute_lazy(uint64_t s[WIDTH]) {
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) s[j] = gl::add_lazy(s[j], RC0[j]);
  // one copy of the full-round code for both halves
#pragma unroll 1
  for (int r = 0; r < pos::N_ROUNDS;) {
    full_round<Mds>(s, r);
    if (++r == pos::HALF_F) {
      partial_rounds(s);
      r += pos::ROUNDS_P;
    }
  }
}

}  // namespace
