// Goldilocks field p = 2^64 - 2^32 + 1 as native-u64 CUDA device functions.
//
// Hopper counterpart of zkevm_prover_tpu/ops/gl_u32.py, the u32-limb layer
// under the TPU's Pallas kernels: an element is one uint64_t, and the
// kernels keep it lazy (any u64 congruent to it) on 32-bit carry chains
// below, canonical() once at the end. Every kernel of the port includes
// this header.
#pragma once

#include <cstdint>

namespace gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;

// a in [0, p) for a lazy a (any u64: a - p < p when a >= p).
__device__ __forceinline__ uint64_t canonical(uint64_t a) {
  return a >= P ? a - P : a;
}

// ---- lazy arithmetic on 32-bit words (inline PTX carry chains) ----------
// "Lazy" values are any u64 congruent to the field element; one canonical()
// at the end makes them canonical. The carry chains (add.cc / addc, mad.cc /
// madc) stand in for the compare-and-select pairs that 64-bit C++ forms
// compile to. Scratch words are asm outputs the C++ never reads
// (kept so: as PTX-local .reg temporaries the same code compiled to more
// instructions), hence the suppressed set-but-not-used warning.
#pragma nv_diag_suppress 550

__device__ __forceinline__ uint32_t lo32(uint64_t a) {
  return static_cast<uint32_t>(a);
}
__device__ __forceinline__ uint32_t hi32(uint64_t a) {
  return static_cast<uint32_t>(a >> 32);
}
__device__ __forceinline__ uint64_t join(uint32_t lo, uint32_t hi) {
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// (r4:r3:r2:r1:r0) mod p, lazy, for r4 < 2^31: (r1:r0) - (r4:r3) + r2 *
// (2^32 - 1), using 2^64 = 2^32 - 1, 2^96 = -1 and 2^128 = -2^32 (mod p).
// A borrow out of the subtraction takes 2^32 - 1 off again, a carry out of
// the addition adds it; neither correction can wrap.
__device__ __forceinline__ uint64_t reduce_words(uint32_t r0, uint32_t r1,
                                                 uint32_t r2, uint32_t r3,
                                                 uint32_t r4 = 0) {
  uint32_t t0, t1, m, u0, u1, s0, s1;
  const uint32_t z = 0;
  asm("sub.cc.u32  %0, %5, %7;\n\t"    // t = (r1:r0) - (r4:r3)
      "subc.cc.u32 %1, %6, %10;\n\t"
      "subc.u32    %2, %9, %9;\n\t"     // m = borrow ? 0xffffffff : 0
      "sub.cc.u32  %0, %0, %2;\n\t"    // t -= (0:m)
      "subc.u32    %1, %1, %9;\n\t"
      "sub.cc.u32  %3, %9, %8;\n\t"    // u = r2 * (2^32 - 1) = (r2:0) - r2
      "subc.u32    %4, %8, %9;\n\t"
      : "=&r"(t0), "=&r"(t1), "=&r"(m), "=&r"(u0), "=&r"(u1)
      : "r"(r0), "r"(r1), "r"(r3), "r"(r2), "r"(z), "r"(r4));
  asm("add.cc.u32  %0, %3, %5;\n\t"    // s = t + u
      "addc.cc.u32 %1, %4, %6;\n\t"
      "addc.u32    %2, %7, %7;\n\t"
      "sub.u32     %2, %7, %2;\n\t"    // m = carry ? 0xffffffff : 0
      "add.cc.u32  %0, %0, %2;\n\t"    // s += (0:m)
      "addc.u32    %1, %1, %7;\n\t"
      : "=&r"(s0), "=&r"(s1), "=&r"(m)
      : "r"(t0), "r"(t1), "r"(u0), "r"(u1), "r"(z));
  return join(s0, s1);
}

// a * b mod p, lazy; a, b any u64. The 128-bit product is four 32x32
// partial products on a mad.cc / madc carry chain.
__device__ __forceinline__ uint64_t mul_lazy(uint64_t a, uint64_t b) {
  const uint32_t a0 = lo32(a), a1 = hi32(a), b0 = lo32(b), b1 = hi32(b);
  uint32_t r0, r1, r2, r3;
  asm("mul.lo.u32     %0, %4, %6;\n\t"
      "mul.hi.u32     %1, %4, %6;\n\t"
      "mad.lo.cc.u32  %1, %4, %7, %1;\n\t"
      "madc.hi.u32    %2, %4, %7, %8;\n\t"
      "mad.lo.cc.u32  %1, %5, %6, %1;\n\t"
      "madc.hi.cc.u32 %2, %5, %6, %2;\n\t"
      "madc.hi.u32    %3, %5, %7, %8;\n\t"
      "mad.lo.cc.u32  %2, %5, %7, %2;\n\t"
      "addc.u32       %3, %3, %8;\n\t"
      : "=&r"(r0), "=&r"(r1), "=&r"(r2), "=&r"(r3)
      : "r"(a0), "r"(a1), "r"(b0), "r"(b1), "r"(0u));
  return reduce_words(r0, r1, r2, r3);
}

// a^2 mod p, lazy: the cross product a0*a1 once, doubled.
__device__ __forceinline__ uint64_t square_lazy(uint64_t a) {
  const uint32_t a0 = lo32(a), a1 = hi32(a);
  uint32_t r0, r1, r2, r3, c1, c2;
  asm("mul.lo.u32     %4, %6, %7;\n\t"   // c = a0 * a1
      "mul.hi.u32     %5, %6, %7;\n\t"
      "add.cc.u32     %4, %4, %4;\n\t"   // (r3:c2:c1) = 2c
      "addc.cc.u32    %5, %5, %5;\n\t"
      "addc.u32       %3, %8, %8;\n\t"
      "mul.lo.u32     %0, %6, %6;\n\t"
      "mad.hi.cc.u32  %1, %6, %6, %4;\n\t"
      "madc.lo.cc.u32 %2, %7, %7, %5;\n\t"
      "madc.hi.u32    %3, %7, %7, %3;\n\t"
      : "=&r"(r0), "=&r"(r1), "=&r"(r2), "=&r"(r3), "=&r"(c1), "=&r"(c2)
      : "r"(a0), "r"(a1), "r"(0u));
  return reduce_words(r0, r1, r2, r3);
}

// a * b + c mod p, lazy; a, b, c any u64 (a*b + c < 2^128): c rides in
// the carry chain of the low partial product.
__device__ __forceinline__ uint64_t mul_add_lazy(uint64_t a, uint64_t b,
                                                 uint64_t c) {
  const uint32_t a0 = lo32(a), a1 = hi32(a), b0 = lo32(b), b1 = hi32(b);
  uint32_t r0, r1, r2, r3;
  asm("mad.lo.cc.u32  %0, %4, %6, %8;\n\t"
      "madc.hi.cc.u32 %1, %4, %6, %9;\n\t"
      "madc.lo.cc.u32 %2, %5, %7, %10;\n\t"
      "madc.hi.u32    %3, %5, %7, %10;\n\t"
      "mad.lo.cc.u32  %1, %4, %7, %1;\n\t"
      "madc.hi.cc.u32 %2, %4, %7, %2;\n\t"
      "addc.u32       %3, %3, %10;\n\t"
      "mad.lo.cc.u32  %1, %5, %6, %1;\n\t"
      "madc.hi.cc.u32 %2, %5, %6, %2;\n\t"
      "addc.u32       %3, %3, %10;\n\t"
      : "=&r"(r0), "=&r"(r1), "=&r"(r2), "=&r"(r3)
      : "r"(a0), "r"(a1), "r"(b0), "r"(b1), "r"(lo32(c)), "r"(hi32(c)),
        "r"(0u));
  return reduce_words(r0, r1, r2, r3);
}

// (r4:r3:r2:r1:r0) += a * b, for a sum of a few products (< 2^159).
__device__ __forceinline__ void mul_acc(uint32_t r[5], uint64_t a,
                                        uint64_t b) {
  const uint32_t a0 = lo32(a), a1 = hi32(a), b0 = lo32(b), b1 = hi32(b);
  asm("mad.lo.cc.u32  %0, %5, %7, %0;\n\t"
      "madc.hi.cc.u32 %1, %5, %7, %1;\n\t"
      "madc.lo.cc.u32 %2, %6, %8, %2;\n\t"
      "madc.hi.cc.u32 %3, %6, %8, %3;\n\t"
      "addc.u32       %4, %4, %9;\n\t"
      "mad.lo.cc.u32  %1, %5, %8, %1;\n\t"
      "madc.hi.cc.u32 %2, %5, %8, %2;\n\t"
      "addc.cc.u32    %3, %3, %9;\n\t"
      "addc.u32       %4, %4, %9;\n\t"
      "mad.lo.cc.u32  %1, %6, %7, %1;\n\t"
      "madc.hi.cc.u32 %2, %6, %7, %2;\n\t"
      "addc.cc.u32    %3, %3, %9;\n\t"
      "addc.u32       %4, %4, %9;\n\t"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4])
      : "r"(a0), "r"(a1), "r"(b0), "r"(b1), "r"(0u));
}

// a + c mod p, lazy, for a any u64 and c < p: a carry out of 2^64 adds
// 2^32 - 1, which cannot wrap again since a + c - 2^64 < c < p.
__device__ __forceinline__ uint64_t add_lazy(uint64_t a, uint64_t c) {
  uint32_t s0, s1, m;
  asm("add.cc.u32  %0, %3, %5;\n\t"
      "addc.cc.u32 %1, %4, %6;\n\t"
      "addc.u32    %2, %7, %7;\n\t"
      "sub.u32     %2, %7, %2;\n\t"
      "add.cc.u32  %0, %0, %2;\n\t"
      "addc.u32    %1, %1, %7;\n\t"
      : "=&r"(s0), "=&r"(s1), "=&r"(m)
      : "r"(lo32(a)), "r"(hi32(a)), "r"(lo32(c)), "r"(hi32(c)), "r"(0u));
  return join(s0, s1);
}

}  // namespace gl
