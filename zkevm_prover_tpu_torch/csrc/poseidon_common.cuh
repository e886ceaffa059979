// Poseidon-Goldilocks width-12 round pieces shared by the port's kernels.
//
// The permutation is 4 full, 22 partial and 4 full rounds of: add the round
// constants, x^7 on every lane (full) or on lane 0 (partial), multiply by
// the small-integer 12x12 MDS. Canonical output, bit-identical to
// poseidon_gl.permute_plain. This header holds what every kernel shares:
// the round counts, the reference MDS compiled in and the lazy S-box.
#pragma once

#include <cstdint>

#include "goldilocks.cuh"

namespace pos {

constexpr int WIDTH = 12;
constexpr int HALF_F = 4;     // full rounds before and after the partial ones
constexpr int ROUNDS_P = 22;
constexpr int N_ROUNDS = 2 * HALF_F + ROUNDS_P;

// ---- the reference MDS compiled in (immediates, not table reads) ----------
// M[i][j] = circ((j - i) mod 12) + (i == j ? diag(i) : 0), the MDS_CIRC and
// MDS_DIAG of ops/poseidon_constants.py. Every row sums to at most 264.
__host__ __device__ constexpr uint32_t circ_coeff(int k) {
  return k == 0 ? 17 : k == 1 ? 15 : k == 2 ? 41 : k == 3 ? 16
       : k == 4 ? 2 : k == 5 ? 28 : k == 6 ? 13 : k == 7 ? 13
       : k == 8 ? 39 : k == 9 ? 18 : k == 10 ? 34 : 20;
}
__host__ __device__ constexpr uint32_t diag_coeff(int i) {
  return i == 0 ? 8 : 0;
}
__host__ __device__ constexpr uint32_t mds_coeff(int i, int j) {
  return circ_coeff((j - i + WIDTH) % WIDTH) + (i == j ? diag_coeff(i) : 0);
}

// (w2:w1:w0) mod p, lazy, for w2 < 2^31: w2 * 2^64 = w2 * (2^32 - 1)
// (mod p), added to (w1:w0); a carry out of that addition adds 2^32 - 1
// once, which cannot wrap again.
__device__ __forceinline__ uint64_t reduce96(uint32_t w0, uint32_t w1,
                                            uint32_t w2) {
  const uint32_t z = 0;
  uint32_t s0, s1, e0, e1;
  asm("sub.cc.u32  %2, %7, %6;\n\t"    // (e1:e0) = w2 * (2^32 - 1)
      "subc.u32    %3, %6, %7;\n\t"    //         = (w2:0) - w2
      "add.cc.u32  %0, %4, %2;\n\t"    // s = (w1:w0) + (e1:e0)
      "addc.cc.u32 %1, %5, %3;\n\t"
      "addc.u32    %3, %7, %7;\n\t"
      "sub.u32     %3, %7, %3;\n\t"    // carry ? 0xffffffff : 0
      "add.cc.u32  %0, %0, %3;\n\t"    // s += (0:that)
      "addc.u32    %1, %1, %7;\n\t"
      : "=&r"(s0), "=&r"(s1), "=&r"(e0), "=&r"(e1)
      : "r"(w0), "r"(w1), "r"(w2), "r"(z));
  return gl::join(s0, s1);
}

// A lane as limbs of 22, 21 and 21 bits, so that a sum of small-integer
// products of one limb over the 12 lanes (row sums <= 264) stays below 2^31.
__device__ __forceinline__ void split_limbs(const uint64_t s[WIDTH],
                                            uint32_t l0[WIDTH],
                                            uint32_t l1[WIDTH],
                                            uint32_t l2[WIDTH]) {
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) {
    const uint32_t lo = gl::lo32(s[j]), hi = gl::hi32(s[j]);
    l0[j] = lo & 0x3FFFFFu;
    l1[j] = __funnelshift_r(lo, hi, 22) & 0x1FFFFFu;
    l2[j] = hi >> 11;
  }
}

// The limb sums a, b, d of one output lane recombined as a + b * 2^22 +
// d * 2^43 + k = (w2:w1:w0) and reduced once, lazy.
__device__ __forceinline__ uint64_t fold_limb_sums(uint32_t a, uint32_t b,
                                                   uint32_t d, uint64_t k) {
  const uint32_t z = 0;
  uint32_t w0, w1, w2;
  asm("add.cc.u32  %0, %3, %4;\n\t"       // A + B << 22
      "addc.cc.u32 %1, %5, %6;\n\t"       // + (B >> 10) + (D << 11)
      "addc.u32    %2, %7, %10;\n\t"      // + (D >> 21)
      "add.cc.u32  %0, %0, %8;\n\t"       // + k
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.u32    %2, %2, %10;\n\t"
      : "=&r"(w0), "=&r"(w1), "=&r"(w2)
      : "r"(a), "r"(b << 22), "r"(b >> 10), "r"(d << 11), "r"(d >> 21),
        "r"(gl::lo32(k)), "r"(gl::hi32(k)), "r"(z));
  return reduce96(w0, w1, w2);
}

// s <- M s + c, lazy in and out, with M's coefficients as immediates: each
// lane as limbs of 22, 21 and 21 bits, each output lane 36 plain 32-bit
// multiply-adds (every limb sum < 264 * 2^22 < 2^31; widening multiply-adds
// on u32 halves measured slower), recombined as A + B * 2^22 + C * 2^43 +
// c = (w2:w1:w0) and reduced once.
__device__ __forceinline__ void mds_fold_limbs(uint64_t s[WIDTH],
                                               const uint64_t* c) {
  uint32_t l0[WIDTH], l1[WIDTH], l2[WIDTH];
  split_limbs(s, l0, l1, l2);
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) {
    uint32_t a = 0, b = 0, d = 0;
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) {
      a += l0[j] * mds_coeff(i, j);
      b += l1[j] * mds_coeff(i, j);
      d += l2[j] * mds_coeff(i, j);
    }
    s[i] = fold_limb_sums(a, b, d, c[i]);
  }
}

// x^7 on lazy values (any u64 in and out): x2 = x^2, x3 = x2 x, x6 = x3^2,
// x7 = x6 x, each product on gl's carry chains.
__device__ __forceinline__ uint64_t sbox_lazy(uint64_t x) {
  const uint64_t x3 = gl::mul_lazy(gl::square_lazy(x), x);
  return gl::mul_lazy(gl::square_lazy(x3), x);
}

}  // namespace pos
