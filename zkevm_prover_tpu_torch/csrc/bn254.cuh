// BN254 field and curve arithmetic for the kernels of csrc/bn254.cu.
//
// Port of the arithmetic of zkevm_prover_tpu/ops/bn254_device.py: fp_add
// :96, fp_sub :102, the CIOS fp_mul :117, to_mont / from_mont :162 / :166,
// the Fp2 of _Fp2Ops :192, jac_double :235 and jac_add :252. Elements are
// 8 little-endian 32-bit limbs in Montgomery form (R = 2^256); the CIOS
// product and the additions run on PTX carry chains (mad.lo.cc / madc.hi /
// add.cc / subc), as csrc/goldilocks.cuh does for Goldilocks. One template
// over a modulus (`Fq`, the base field p, for G1 and G2; `Fr`, the scalar
// field r, for the NTT), and the curve templates over a field type
// (`Fe<Fq>` for G1, `Fe2` for G2).
//
// Both moduli are below 2^254, so a sum of two reduced elements fits in 8
// limbs, and the CIOS accumulator stays below 2^288 (9 limbs) and below 2p
// at the end of each outer step.
#pragma once

#include <cstdint>

namespace bn254 {

// The moduli's constants, read through accessors that index a local
// constexpr table: after unrolling the index is a constant and the limb an
// immediate (no host array is read on the card).
struct Fq {
  static constexpr uint32_t NP = 0xe4866389;  // -p^-1 mod 2^32
  static constexpr bool UNROLL = false;       // fmul's steps as a loop
  static __device__ __forceinline__ uint32_t p(int j) {
    constexpr uint32_t v[8] = {0xd87cfd47, 0x3c208c16, 0x6871ca8d, 0x97816a91,
                               0x8181585d, 0xb85045b6, 0xe131a029, 0x30644e72};
    return v[j];
  }
  static __device__ __forceinline__ uint32_t r2(int j) {  // 2^512 mod p
    constexpr uint32_t v[8] = {0x538afa89, 0xf32cfc5b, 0xd44501fb, 0xb5e71911,
                               0x0a417ff6, 0x47ab1eff, 0xcab8351f, 0x06d89f71};
    return v[j];
  }
  static __device__ __forceinline__ uint32_t one(int j) {  // 2^256 mod p
    constexpr uint32_t v[8] = {0xc58f0d9d, 0xd35d438d, 0xf5c70b3d, 0x0a78eb28,
                               0x7879462c, 0x666ea36f, 0x9a07df2f, 0x0e0a77c1};
    return v[j];
  }
  static __device__ __forceinline__ uint32_t r3(int j) {  // 2^768 mod p
    constexpr uint32_t v[8] = {0xda1530df, 0xb1cd6daf, 0xa7283db6, 0x62f210e6,
                               0x0ada0afb, 0xef7f0b0c, 0x2d592544, 0x20fd6e90};
    return v[j];
  }
};

struct Fr {
  static constexpr uint32_t NP = 0xefffffff;
  static constexpr bool UNROLL = true;
  static __device__ __forceinline__ uint32_t p(int j) {
    constexpr uint32_t v[8] = {0xf0000001, 0x43e1f593, 0x79b97091, 0x2833e848,
                               0x8181585d, 0xb85045b6, 0xe131a029, 0x30644e72};
    return v[j];
  }
  static __device__ __forceinline__ uint32_t r2(int j) {
    constexpr uint32_t v[8] = {0xae216da7, 0x1bb8e645, 0xe35c59e3, 0x53fe3ab1,
                               0x53bb8085, 0x8c49833d, 0x7f4e44a5, 0x0216d0b1};
    return v[j];
  }
  static __device__ __forceinline__ uint32_t one(int j) {
    constexpr uint32_t v[8] = {0x4ffffffb, 0xac96341c, 0x9f60cd29, 0x36fc7695,
                               0x7879462e, 0x666ea36f, 0x9a07df2f, 0x0e0a77c1};
    return v[j];
  }
  static __device__ __forceinline__ uint32_t r3(int j) {
    constexpr uint32_t v[8] = {0xb4bf0040, 0x5e94d8e1, 0x1cfbb6b8, 0x2a489cbe,
                               0xa19fcfed, 0x893cc664, 0x7fcc657c, 0x0cf8594b};
    return v[j];
  }
};

template <class M>
struct Fe {
  uint32_t v[8];
};

// ---------------------------------------------------------------------------
// Fp / Fr: Montgomery arithmetic
// ---------------------------------------------------------------------------

// d = a - p (limb-wise with borrow); returns 0xffffffff if a < p, else 0
template <class M>
__device__ __forceinline__ uint32_t sub_p(uint32_t d[8], const uint32_t a[8]) {
  uint32_t bw;
  asm("sub.cc.u32  %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32    %8, %25, %25;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]),
        "=r"(d[5]), "=r"(d[6]), "=r"(d[7]), "=r"(bw)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(M::p(0)), "r"(M::p(1)), "r"(M::p(2)),
        "r"(M::p(3)), "r"(M::p(4)), "r"(M::p(5)), "r"(M::p(6)),
        "r"(M::p(7)), "r"(0u));
  return bw;
}

// r = a if a < p else a - p (a < 2p)
template <class M>
__device__ __forceinline__ void reduce_once(uint32_t r[8], const uint32_t a[8]) {
  uint32_t d[8];
  uint32_t bw = sub_p<M>(d, a);
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = bw ? a[j] : d[j];
}

template <class M>
__device__ __forceinline__ void fadd(Fe<M>& r, const Fe<M>& a, const Fe<M>& b) {
  uint32_t s[8];
  asm("add.cc.u32  %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32    %7, %15, %23;"
      : "=r"(s[0]), "=r"(s[1]), "=r"(s[2]), "=r"(s[3]), "=r"(s[4]),
        "=r"(s[5]), "=r"(s[6]), "=r"(s[7])
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]),
        "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]),
        "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]),
        "r"(b.v[7]));
  reduce_once<M>(r.v, s);
}

template <class M>
__device__ __forceinline__ void fsub(Fe<M>& r, const Fe<M>& a, const Fe<M>& b) {
  uint32_t d[8], bw;
  asm("sub.cc.u32  %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32    %8, %25, %25;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]),
        "=r"(d[5]), "=r"(d[6]), "=r"(d[7]), "=r"(bw)
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]),
        "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]),
        "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]),
        "r"(b.v[7]), "r"(0u));
  // a < b: add p back (the masked modulus)
  asm("add.cc.u32  %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32    %7, %7, %15;"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "r"(M::p(0) & bw), "r"(M::p(1) & bw), "r"(M::p(2) & bw),
        "r"(M::p(3) & bw), "r"(M::p(4) & bw), "r"(M::p(5) & bw),
        "r"(M::p(6) & bw), "r"(M::p(7) & bw));
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = d[j];
}

// One outer step of the CIOS Montgomery product: t += ai * b (a lo chain
// into t[0..7] with its carry into t[8], then a hi chain into t[1..8]),
// then t += m * p with m = t[0] * NP (the same two chains; t[0] becomes 0),
// and t shifts down one limb.
template <class M>
__device__ __forceinline__ void cios_step(uint32_t (&t)[9], uint32_t ai,
                                          const Fe<M>& b) {
  asm("mad.lo.cc.u32  %0, %9, %10, %0;\n\t"
      "madc.lo.cc.u32 %1, %9, %11, %1;\n\t"
      "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
      "madc.lo.cc.u32 %3, %9, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %9, %14, %4;\n\t"
      "madc.lo.cc.u32 %5, %9, %15, %5;\n\t"
      "madc.lo.cc.u32 %6, %9, %16, %6;\n\t"
      "madc.lo.cc.u32 %7, %9, %17, %7;\n\t"
      "addc.u32       %8, %8, %18;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
      : "r"(ai), "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]),
        "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]), "r"(0u));
  asm("mad.hi.cc.u32  %0, %8, %9, %0;\n\t"
      "madc.hi.cc.u32 %1, %8, %10, %1;\n\t"
      "madc.hi.cc.u32 %2, %8, %11, %2;\n\t"
      "madc.hi.cc.u32 %3, %8, %12, %3;\n\t"
      "madc.hi.cc.u32 %4, %8, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %8, %14, %5;\n\t"
      "madc.hi.cc.u32 %6, %8, %15, %6;\n\t"
      "madc.hi.u32    %7, %8, %16, %7;"
      : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]),
        "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
      : "r"(ai), "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]),
        "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]));
  const uint32_t m = t[0] * M::NP;
  asm("mad.lo.cc.u32  %0, %9, %10, %0;\n\t"
      "madc.lo.cc.u32 %1, %9, %11, %1;\n\t"
      "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
      "madc.lo.cc.u32 %3, %9, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %9, %14, %4;\n\t"
      "madc.lo.cc.u32 %5, %9, %15, %5;\n\t"
      "madc.lo.cc.u32 %6, %9, %16, %6;\n\t"
      "madc.lo.cc.u32 %7, %9, %17, %7;\n\t"
      "addc.u32       %8, %8, %18;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
      : "r"(m), "r"(M::p(0)), "r"(M::p(1)), "r"(M::p(2)), "r"(M::p(3)),
        "r"(M::p(4)), "r"(M::p(5)), "r"(M::p(6)), "r"(M::p(7)), "r"(0u));
  asm("mad.hi.cc.u32  %0, %8, %9, %0;\n\t"
      "madc.hi.cc.u32 %1, %8, %10, %1;\n\t"
      "madc.hi.cc.u32 %2, %8, %11, %2;\n\t"
      "madc.hi.cc.u32 %3, %8, %12, %3;\n\t"
      "madc.hi.cc.u32 %4, %8, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %8, %14, %5;\n\t"
      "madc.hi.cc.u32 %6, %8, %15, %6;\n\t"
      "madc.hi.u32    %7, %8, %16, %7;"
      : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]),
        "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
      : "r"(m), "r"(M::p(0)), "r"(M::p(1)), "r"(M::p(2)), "r"(M::p(3)),
        "r"(M::p(4)), "r"(M::p(5)), "r"(M::p(6)), "r"(M::p(7)));
#pragma unroll
  for (int j = 0; j < 8; ++j) t[j] = t[j + 1];
  t[8] = 0;
}

// CIOS Montgomery product r = a * b / 2^256 mod p (a, b < p): eight
// outer steps. Over Fr (the NTT's butterflies, one product a kernel) the
// steps are unrolled: as the G1 library's loop, the NTT at 2^22 took 12 %
// longer and the pointwise step 9 % (PERF.md §6, by `msm_bench --parent`
// on an NVIDIA H100). Over Fq they run as a loop, a's limbs moving down
// the registers a step at a time: unrolled, a product is about 600 SASS
// instructions, and a group law of 10-30 of them outgrows the SM's
// instruction cache, which slowed both a loop of products and a lone
// thread's chain of them on the H100, where the rolled loop keeps its
// rate at any code size. Two steps a trip in the G1 library, one in the
// G2 library, whose Fp2 group law is three times the code: each the
// faster of the two for its group's MSM.
template <class M>
__device__ __forceinline__ void fmul(Fe<M>& r, const Fe<M>& a, const Fe<M>& b) {
  uint32_t t[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) t[j] = 0;
  if constexpr (M::UNROLL) {
#pragma unroll
    for (int i = 0; i < 8; ++i) cios_step<M>(t, a.v[i], b);
  } else {
    uint32_t av[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) av[j] = a.v[j];
#if defined(BN254_G2) && BN254_G2
#pragma unroll 1
#else
#pragma unroll 2
#endif
    for (int i = 0; i < 8; ++i) {
      const uint32_t ai = av[0];
#pragma unroll
      for (int j = 0; j < 7; ++j) av[j] = av[j + 1];
      cios_step<M>(t, ai, b);
    }
  }
  reduce_once<M>(r.v, t);
}

template <class M>
__device__ __forceinline__ void fsq(Fe<M>& r, const Fe<M>& a) {
  fmul(r, a, a);
}

// K independent products r[k] = a[k] * b[k] by the lanes of a warp that
// all hold the same operands: lane k forms product k, and every lane gets
// all K back by shuffles. A lone chain of products (the MSM's Horner pass)
// then waits for one product's latency a batch instead of K; every lane
// of the warp must call it.
template <class M, int K>
__device__ __forceinline__ void fmul_warp(Fe<M> (&r)[K], const Fe<M> (&a)[K],
                                          const Fe<M> (&b)[K]) {
  const int lane = threadIdx.x & 31;
  Fe<M> x = a[0], y = b[0], z;
#pragma unroll
  for (int k = 1; k < K; ++k) {
    if (lane == k) {
      x = a[k];
      y = b[k];
    }
  }
  fmul(z, x, y);
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < 8; ++j) r[k].v[j] = __shfl_sync(0xffffffffu, z.v[j], k);
  }
}

template <class M>
__device__ __forceinline__ bool fis_zero(const Fe<M>& a) {
  uint32_t o = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) o |= a.v[j];
  return o == 0;
}

template <class M>
__device__ __forceinline__ void fset_zero(Fe<M>& a) {
#pragma unroll
  for (int j = 0; j < 8; ++j) a.v[j] = 0;
}

template <class M>
__device__ __forceinline__ void fset_one(Fe<M>& a) {  // Montgomery 1
#pragma unroll
  for (int j = 0; j < 8; ++j) a.v[j] = M::one(j);
}

template <class M>
__device__ __forceinline__ void to_mont(Fe<M>& r, const Fe<M>& a) {
  Fe<M> r2;
#pragma unroll
  for (int j = 0; j < 8; ++j) r2.v[j] = M::r2(j);
  fmul(r, a, r2);
}

template <class M>
__device__ __forceinline__ void from_mont(Fe<M>& r, const Fe<M>& a) {
  Fe<M> one;
  fset_zero(one);
  one.v[0] = 1;
  fmul(r, a, one);
}

// a >>= 1 over 8 limbs
__device__ __forceinline__ void shr1(uint32_t (&a)[8]) {
#pragma unroll
  for (int j = 0; j < 7; ++j) a[j] = __funnelshift_r(a[j], a[j + 1], 1);
  a[7] >>= 1;
}

// x / 2 mod p for x < p: (x + p) / 2 when x is odd (x + p < 2^255)
template <class M>
__device__ __forceinline__ void half_mod(uint32_t (&x)[8]) {
  if (x[0] & 1) {
    asm("add.cc.u32  %0, %0, %8;\n\t"
        "addc.cc.u32 %1, %1, %9;\n\t"
        "addc.cc.u32 %2, %2, %10;\n\t"
        "addc.cc.u32 %3, %3, %11;\n\t"
        "addc.cc.u32 %4, %4, %12;\n\t"
        "addc.cc.u32 %5, %5, %13;\n\t"
        "addc.cc.u32 %6, %6, %14;\n\t"
        "addc.u32    %7, %7, %15;"
        : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "+r"(x[4]),
          "+r"(x[5]), "+r"(x[6]), "+r"(x[7])
        : "r"(M::p(0)), "r"(M::p(1)), "r"(M::p(2)), "r"(M::p(3)),
          "r"(M::p(4)), "r"(M::p(5)), "r"(M::p(6)), "r"(M::p(7)));
  }
  shr1(x);
}

// d = a - b over 8 limbs; returns 0xffffffff if a < b, else 0
__device__ __forceinline__ uint32_t sub8(uint32_t (&d)[8], const uint32_t (&a)[8],
                                         const uint32_t (&b)[8]) {
  uint32_t bw;
  asm("sub.cc.u32  %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32    %8, %25, %25;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]),
        "=r"(d[5]), "=r"(d[6]), "=r"(d[7]), "=r"(bw)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]),
        "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]), "r"(0u));
  return bw;
}

__device__ __forceinline__ bool is_one8(const uint32_t (&a)[8]) {
  uint32_t o = a[0] ^ 1u;
#pragma unroll
  for (int j = 1; j < 8; ++j) o |= a[j];
  return o == 0;
}

// The inverse by the binary extended Euclidean algorithm: a lone thread's
// inversion (a batch inversion's root, the MSM's last point) is on the
// critical path of its block, and this takes about 25,000 simple
// instructions where the Fermat power a^(p-2) takes 380 products (about
// 200,000), so an eighth of the instructions and of the latency. On
// Montgomery form: u = a R is inverted as an integer, (a R)^-1 =
// a^-1 R^-1, and one product by R^3 gives a^-1 R. Invariants
// x1 * u0 = u and x2 * u0 = v (mod p), u0 the input; 0 -> 0.
template <class M>
__device__ __noinline__ void finv(Fe<M>& r, const Fe<M>& a) {
  uint32_t u[8], v[8], x1[8], x2[8], d[8];
  uint32_t any = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    u[j] = a.v[j];
    v[j] = M::p(j);
    x1[j] = 0;
    x2[j] = 0;
    any |= a.v[j];
  }
  if (!any) {
    fset_zero(r);
    return;
  }
  x1[0] = 1;
  while (!is_one8(u) && !is_one8(v)) {
    while (!(u[0] & 1)) {
      shr1(u);
      half_mod<M>(x1);
    }
    while (!(v[0] & 1)) {
      shr1(v);
      half_mod<M>(x2);
    }
    if (!sub8(d, u, v)) {   // u >= v
#pragma unroll
      for (int j = 0; j < 8; ++j) u[j] = d[j];
      Fe<M> s, t;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s.v[j] = x1[j];
        t.v[j] = x2[j];
      }
      fsub(s, s, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) x1[j] = s.v[j];
    } else {
      sub8(d, v, u);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = d[j];
      Fe<M> s, t;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s.v[j] = x2[j];
        t.v[j] = x1[j];
      }
      fsub(s, s, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) x2[j] = s.v[j];
    }
  }
  Fe<M> inv, r3;
  const bool one_u = is_one8(u);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    inv.v[j] = one_u ? x1[j] : x2[j];
    r3.v[j] = M::r3(j);
  }
  fmul(r, inv, r3);
}

// ---------------------------------------------------------------------------
// Fp2 = Fp[u]/(u^2 + 1)
// ---------------------------------------------------------------------------

struct Fe2 {
  Fe<Fq> c0, c1;
};

__device__ __forceinline__ void fadd(Fe2& r, const Fe2& a, const Fe2& b) {
  fadd(r.c0, a.c0, b.c0);
  fadd(r.c1, a.c1, b.c1);
}

__device__ __forceinline__ void fsub(Fe2& r, const Fe2& a, const Fe2& b) {
  fsub(r.c0, a.c0, b.c0);
  fsub(r.c1, a.c1, b.c1);
}

// Karatsuba, as _Fp2Ops.mul
__device__ __forceinline__ void fmul(Fe2& r, const Fe2& a, const Fe2& b) {
  Fe<Fq> m00, m11, sa, sb, cross;
  fmul(m00, a.c0, b.c0);
  fmul(m11, a.c1, b.c1);
  fadd(sa, a.c0, a.c1);
  fadd(sb, b.c0, b.c1);
  fmul(cross, sa, sb);
  fsub(r.c0, m00, m11);
  fsub(cross, cross, m00);
  fsub(r.c1, cross, m11);
}

// complex squaring: (a0 + a1 u)^2 = (a0 + a1)(a0 - a1) + 2 a0 a1 u, two
// products where the Karatsuba product takes three
__device__ __forceinline__ void fsq(Fe2& r, const Fe2& a) {
  Fe<Fq> s, d, m;
  fadd(s, a.c0, a.c1);
  fsub(d, a.c0, a.c1);
  fmul(m, a.c0, a.c1);
  fmul(r.c0, s, d);
  fadd(r.c1, m, m);
}

__device__ __forceinline__ bool fis_zero(const Fe2& a) {
  return fis_zero(a.c0) && fis_zero(a.c1);
}

__device__ __forceinline__ void fset_zero(Fe2& a) {
  fset_zero(a.c0);
  fset_zero(a.c1);
}

__device__ __forceinline__ void fset_one(Fe2& a) {
  fset_one(a.c0);
  fset_zero(a.c1);
}

// 1 / (a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2)
__device__ __noinline__ void finv(Fe2& r, const Fe2& a) {
  Fe<Fq> n, t, z;
  fsq(n, a.c0);
  fsq(t, a.c1);
  fadd(n, n, t);
  finv(n, n);
  fmul(r.c0, a.c0, n);
  fmul(t, a.c1, n);
  fset_zero(z);
  fsub(r.c1, z, t);
}

template <class M>
__device__ __forceinline__ void fneg(Fe<M>& r, const Fe<M>& a) {
  Fe<M> z;
  fset_zero(z);
  fsub(r, z, a);
}

__device__ __forceinline__ void fneg(Fe2& r, const Fe2& a) {
  fneg(r.c0, a.c0);
  fneg(r.c1, a.c1);
}

// ---------------------------------------------------------------------------
// The curve y^2 = x^3 + b (a = 0) in Jacobian coordinates: x = X/Z^2,
// y = Y/Z^3, infinity is Z = 0. Field-generic: F = Fe<Fq> (G1) or Fe2 (G2).
// The mixed addition (the fixed-base loop's step) and the full addition
// (the MSM's Horner pass) are inlined; the doubling, their rare branch, is
// a call, compiled once.
// ---------------------------------------------------------------------------

template <class F>
struct Jac {
  F X, Y, Z;
};

template <class F>
struct Aff {
  F x, y;
};

template <class F>
__device__ __forceinline__ void jac_set_inf(Jac<F>& p) {
  fset_one(p.X);
  fset_one(p.Y);
  fset_zero(p.Z);
}

// dbl-2009-l, as jac_double :235 (the result aliases nothing it reads late)
template <class F>
__device__ __forceinline__ void jac_double_inl(Jac<F>& r, const Jac<F>& p) {
  F A, B, C, D, E, G, t, X3, Y3, Z3;
  fsq(A, p.X);
  fsq(B, p.Y);
  fsq(C, B);
  fadd(t, p.X, B);
  fsq(t, t);
  fsub(t, t, A);
  fsub(t, t, C);
  fadd(D, t, t);
  fadd(E, A, A);
  fadd(E, E, A);
  fsq(G, E);
  fadd(t, D, D);
  fsub(X3, G, t);
  fsub(t, D, X3);
  fmul(Y3, E, t);
  fadd(t, C, C);
  fadd(t, t, t);
  fadd(t, t, t);
  fsub(Y3, Y3, t);
  fmul(Z3, p.Y, p.Z);
  fadd(Z3, Z3, Z3);
  r.X = X3;
  r.Y = Y3;
  r.Z = Z3;
}

template <class F>
__device__ __noinline__ void jac_double(Jac<F>& r, const Jac<F>& p) {
  jac_double_inl(r, p);
}

// dbl-2009-l again for a warp that holds one point in every lane, its
// products in three batches of independent ones (A, B, Y Z; then C,
// (X + B)^2, E^2; then E (D - X3)) spread over the lanes (fmul_warp): the
// Horner pass's chain of doublings waits for three products' latency a
// doubling, not seven
__device__ __forceinline__ void jac_double_lat(Jac<Fe<Fq>>& p) {
  using E1 = Fe<Fq>;
  E1 o[3], t, D, E, X3;
  {
    const E1 a[3] = {p.X, p.Y, p.Y}, b[3] = {p.X, p.Y, p.Z};
    fmul_warp<Fq, 3>(o, a, b);                 // A, B, Y Z
  }
  const E1 A = o[0], B = o[1];
  fadd(p.Z, o[2], o[2]);
  fadd(E, A, A);
  fadd(E, E, A);
  fadd(t, p.X, B);
  {
    const E1 a[3] = {B, t, E}, b[3] = {B, t, E};
    fmul_warp<Fq, 3>(o, a, b);                 // C, (X + B)^2, E^2
  }
  fsub(t, o[1], A);
  fsub(t, t, o[0]);
  fadd(D, t, t);
  fadd(t, D, D);
  fsub(X3, o[2], t);
  fsub(t, D, X3);
  fmul(t, E, t);
  fadd(D, o[0], o[0]);
  fadd(D, D, D);
  fadd(D, D, D);
  fsub(p.Y, t, D);
  p.X = X3;
}

// over Fp2: a square (u + v i)^2 = (u + v)(u - v) + 2 u v i is two Fp
// products, a product three (Karatsuba); the same three batches hold 7, 6
// and 3 Fp products
__device__ __forceinline__ void fp2_sq_in(Fe<Fq>* a, Fe<Fq>* b, const Fe2& x) {
  fadd(a[0], x.c0, x.c1);
  fsub(b[0], x.c0, x.c1);
  a[1] = x.c0;
  b[1] = x.c1;
}
__device__ __forceinline__ void fp2_sq_out(Fe2& r, const Fe<Fq>* o) {
  r.c0 = o[0];
  fadd(r.c1, o[1], o[1]);
}
__device__ __forceinline__ void fp2_mul_in(Fe<Fq>* a, Fe<Fq>* b, const Fe2& x,
                                           const Fe2& y) {
  a[0] = x.c0;
  b[0] = y.c0;
  a[1] = x.c1;
  b[1] = y.c1;
  fadd(a[2], x.c0, x.c1);
  fadd(b[2], y.c0, y.c1);
}
__device__ __forceinline__ void fp2_mul_out(Fe2& r, const Fe<Fq>* o) {
  fsub(r.c0, o[0], o[1]);
  fsub(r.c1, o[2], o[0]);
  fsub(r.c1, r.c1, o[1]);
}

__device__ __forceinline__ void jac_double_lat(Jac<Fe2>& p) {
  using E1 = Fe<Fq>;
  Fe2 A, B, t, D, E, X3;
  {
    E1 a[7], b[7], o[7];
    fp2_sq_in(a, b, p.X);
    fp2_sq_in(a + 2, b + 2, p.Y);
    fp2_mul_in(a + 4, b + 4, p.Y, p.Z);
    fmul_warp<Fq, 7>(o, a, b);                 // A, B, Y Z
    fp2_sq_out(A, o);
    fp2_sq_out(B, o + 2);
    fp2_mul_out(t, o + 4);
    fadd(p.Z, t, t);
  }
  fadd(E, A, A);
  fadd(E, E, A);
  fadd(t, p.X, B);
  Fe2 C, T, G;
  {
    E1 a[6], b[6], o[6];
    fp2_sq_in(a, b, B);
    fp2_sq_in(a + 2, b + 2, t);
    fp2_sq_in(a + 4, b + 4, E);
    fmul_warp<Fq, 6>(o, a, b);                 // C, (X + B)^2, E^2
    fp2_sq_out(C, o);
    fp2_sq_out(T, o + 2);
    fp2_sq_out(G, o + 4);
  }
  fsub(t, T, A);
  fsub(t, t, C);
  fadd(D, t, t);
  fadd(t, D, D);
  fsub(X3, G, t);
  fsub(t, D, X3);
  {
    E1 a[3], b[3], o[3];
    fp2_mul_in(a, b, E, t);
    fmul_warp<Fq, 3>(o, a, b);                 // E (D - X3)
    fp2_mul_out(t, o);
  }
  fadd(D, C, C);
  fadd(D, D, D);
  fadd(D, D, D);
  fsub(p.Y, t, D);
  p.X = X3;
}

// p + q with q affine and not infinity (madd-2007-bl); complete: p at
// infinity, p == q (doubling) and p == -q (infinity) take their own branch
template <class F>
__device__ __forceinline__ void jac_add_mixed(Jac<F>& r, const Jac<F>& p,
                                              const Aff<F>& q) {
  if (fis_zero(p.Z)) {
    r.X = q.x;
    r.Y = q.y;
    fset_one(r.Z);
    return;
  }
  F Z1Z1, U2, S2, H, HH, I, J, rr, V, t, X3, Y3, Z3;
  fsq(Z1Z1, p.Z);
  fmul(U2, q.x, Z1Z1);
  fmul(t, p.Z, Z1Z1);
  fmul(S2, q.y, t);
  fsub(H, U2, p.X);
  fsub(rr, S2, p.Y);
  if (fis_zero(H)) {
    if (fis_zero(rr)) {
      jac_double(r, p);
    } else {
      jac_set_inf(r);
    }
    return;
  }
  fadd(rr, rr, rr);
  fsq(HH, H);
  fadd(I, HH, HH);
  fadd(I, I, I);
  fmul(J, H, I);
  fmul(V, p.X, I);
  fsq(X3, rr);
  fsub(X3, X3, J);
  fsub(X3, X3, V);
  fsub(X3, X3, V);
  fsub(t, V, X3);
  fmul(Y3, rr, t);
  fmul(t, p.Y, J);
  fadd(t, t, t);
  fsub(Y3, Y3, t);
  fadd(t, p.Z, H);
  fsq(t, t);
  fsub(t, t, Z1Z1);
  fsub(Z3, t, HH);
  r.X = X3;
  r.Y = Y3;
  r.Z = Z3;
}

// p + q, both Jacobian (add-2007-bl), complete as jac_add :252
template <class F>
__device__ __forceinline__ void jac_add(Jac<F>& r, const Jac<F>& p,
                                        const Jac<F>& q) {
  if (fis_zero(p.Z)) {
    r = q;
    return;
  }
  if (fis_zero(q.Z)) {
    r = p;
    return;
  }
  F Z1Z1, Z2Z2, U1, U2, S1, S2, H, I, J, rr, V, t, X3, Y3, Z3;
  fsq(Z1Z1, p.Z);
  fsq(Z2Z2, q.Z);
  fmul(U1, p.X, Z2Z2);
  fmul(U2, q.X, Z1Z1);
  fmul(t, q.Z, Z2Z2);
  fmul(S1, p.Y, t);
  fmul(t, p.Z, Z1Z1);
  fmul(S2, q.Y, t);
  fsub(H, U2, U1);
  fsub(rr, S2, S1);
  if (fis_zero(H)) {
    if (fis_zero(rr)) {
      jac_double(r, p);
    } else {
      jac_set_inf(r);
    }
    return;
  }
  fadd(I, H, H);
  fsq(I, I);
  fmul(J, H, I);
  fadd(rr, rr, rr);
  fmul(V, U1, I);
  fsq(X3, rr);
  fsub(X3, X3, J);
  fsub(X3, X3, V);
  fsub(X3, X3, V);
  fsub(t, V, X3);
  fmul(Y3, rr, t);
  fmul(t, S1, J);
  fadd(t, t, t);
  fsub(Y3, Y3, t);
  fadd(t, p.Z, q.Z);
  fsq(t, t);
  fsub(t, t, Z1Z1);
  fsub(t, t, Z2Z2);
  fmul(Z3, t, H);
  r.X = X3;
  r.Y = Y3;
  r.Z = Z3;
}

// ---------------------------------------------------------------------------
// XYZZ coordinates (Bernstein and Lange's explicit-formula database,
// "xyzz" for short Weierstrass curves): x = X/ZZ, y = Y/ZZZ with
// ZZ^3 = ZZZ^2 (ZZ = z^2, ZZZ = z^3 for some z), infinity ZZ = 0. The MSM's
// buckets and sums run in them: a mixed addition is 8 products and 2
// squarings (madd-2008-s; Jacobian's madd-2007-bl 7 and 4), a full one 12
// and 2 (add-2008-s; add-2007-bl 11 and 5). Over Fp2 with three-product
// Karatsuba and two-product squaring that is 28 and 40 Fp products where
// Jacobian needs 29 and 43. The doubling (dbl-2008-s-1, 6 and 3) is the
// cold path of an addition of a point to itself.
// ---------------------------------------------------------------------------

template <class F>
struct Xyzz {
  F X, Y, ZZ, ZZZ;
};

template <class F>
__device__ __forceinline__ void xyzz_set_inf(Xyzz<F>& p) {
  fset_one(p.X);
  fset_one(p.Y);
  fset_zero(p.ZZ);
  fset_zero(p.ZZZ);
}

// 2 p (dbl-2008-s-1, a = 0): U = 2Y, V = U^2, W = U V, S = X V, M = 3 X^2;
// X3 = M^2 - 2S, Y3 = M (S - X3) - W Y, ZZ3 = V ZZ, ZZZ3 = W ZZZ
template <class F>
__device__ __forceinline__ void xyzz_double_inl(Xyzz<F>& r, const Xyzz<F>& p) {
  if (fis_zero(p.ZZ)) {
    r = p;
    return;
  }
  F U, V, W, S, M, t, X3;
  fadd(U, p.Y, p.Y);
  fsq(V, U);
  fmul(W, U, V);
  fmul(S, p.X, V);
  fsq(t, p.X);
  fadd(M, t, t);
  fadd(M, M, t);
  fsq(X3, M);
  fsub(X3, X3, S);
  fsub(X3, X3, S);
  fsub(t, S, X3);
  fmul(t, M, t);
  fmul(U, W, p.Y);
  fsub(r.Y, t, U);
  fmul(r.ZZ, V, p.ZZ);
  fmul(r.ZZZ, W, p.ZZZ);
  r.X = X3;
}

// p += q, q affine and not infinity (madd-2008-s); complete: p at
// infinity, p == q (doubling) and p == -q (infinity) take their own branch.
// Inlined whole, the doubling too: a call that took p by reference would
// put the caller's running sum in local memory.
template <class F>
__device__ __forceinline__ void xyzz_add_mixed(Xyzz<F>& p, const Aff<F>& q) {
  if (fis_zero(p.ZZ)) {
    p.X = q.x;
    p.Y = q.y;
    fset_one(p.ZZ);
    fset_one(p.ZZZ);
    return;
  }
  F P, R, t;
  fmul(t, q.x, p.ZZ);
  fsub(P, t, p.X);
  fmul(t, q.y, p.ZZZ);
  fsub(R, t, p.Y);
  if (fis_zero(P)) {
    if (fis_zero(R)) {
      Xyzz<F> a;
      a.X = q.x;
      a.Y = q.y;
      fset_one(a.ZZ);
      fset_one(a.ZZZ);
      xyzz_double_inl(p, a);
    } else {
      xyzz_set_inf(p);
    }
    return;
  }
  F PP, Q;
  fsq(PP, P);
  fmul(P, P, PP);          // PPP
  fmul(p.ZZ, p.ZZ, PP);
  fmul(Q, p.X, PP);
  fmul(p.ZZZ, p.ZZZ, P);
  fsq(t, R);
  fsub(t, t, P);
  fsub(t, t, Q);
  fsub(p.X, t, Q);         // X3 = R^2 - PPP - 2Q
  fsub(Q, Q, p.X);
  fmul(Q, R, Q);
  fmul(t, p.Y, P);
  fsub(p.Y, Q, t);         // Y3 = R (Q - X3) - Y1 PPP
}

// p += q, both XYZZ (add-2008-s), complete
template <class F>
__device__ __forceinline__ void xyzz_add_inl(Xyzz<F>& p, const Xyzz<F>& q) {
  if (fis_zero(q.ZZ)) return;
  if (fis_zero(p.ZZ)) {
    p = q;
    return;
  }
  F U1, S1, P, R, t;
  fmul(U1, p.X, q.ZZ);
  fmul(t, q.X, p.ZZ);
  fsub(P, t, U1);
  fmul(S1, p.Y, q.ZZZ);
  fmul(t, q.Y, p.ZZZ);
  fsub(R, t, S1);
  if (fis_zero(P)) {
    if (fis_zero(R)) {
      xyzz_double_inl(p, p);
    } else {
      xyzz_set_inf(p);
    }
    return;
  }
  F PP;
  fsq(PP, P);
  fmul(P, P, PP);          // PPP
  fmul(p.ZZ, p.ZZ, q.ZZ);
  fmul(p.ZZ, p.ZZ, PP);
  fmul(p.ZZZ, p.ZZZ, q.ZZZ);
  fmul(p.ZZZ, p.ZZZ, P);
  fmul(U1, U1, PP);        // Q
  fsq(t, R);
  fsub(t, t, P);
  fsub(t, t, U1);
  fsub(p.X, t, U1);        // X3 = R^2 - PPP - 2Q
  fsub(U1, U1, p.X);
  fmul(U1, R, U1);
  fmul(t, S1, P);
  fsub(p.Y, U1, t);        // Y3 = R (Q - X3) - S1 PPP
}

// *p = 2 *p in shared or device memory
template <class F>
__device__ __noinline__ void xyzz_dbl(Xyzz<F>* p) {
  Xyzz<F> a = *p;
  xyzz_double_inl(a, a);
  *p = a;
}

// *p += *q for points in shared or device memory: one out-of-line copy of
// the addition for the reductions, whose operands never live in a
// thread's local memory
template <class F>
__device__ __noinline__ void xyzz_acc(Xyzz<F>* p, const Xyzz<F>* q) {
  Xyzz<F> a = *p;
  xyzz_add_inl(a, *q);
  *p = a;
}

// the same point in Jacobian coordinates, with Z = ZZ ZZZ (= z^5):
// X = X ZZ ZZZ^2, Y = Y ZZZ^4
template <class F>
__device__ __forceinline__ void xyzz_to_jac(Jac<F>& r, const Xyzz<F>& p) {
  if (fis_zero(p.ZZ)) {
    jac_set_inf(r);
    return;
  }
  F t, u;
  fsq(t, p.ZZZ);
  fmul(r.Z, p.ZZ, p.ZZZ);
  fmul(u, p.ZZ, t);
  fmul(r.X, p.X, u);
  fsq(t, t);
  fmul(r.Y, p.Y, t);
}

}  // namespace bn254
