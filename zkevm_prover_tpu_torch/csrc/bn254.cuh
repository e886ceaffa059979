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
};

struct Fr {
  static constexpr uint32_t NP = 0xefffffff;
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

// CIOS Montgomery product r = a * b / 2^256 mod p (a, b < p). The
// accumulator t[0..8]: each outer step adds a_i * b (a lo chain into
// t[0..7] with its carry into t[8], then a hi chain into t[1..8]), then
// m * p with m = t[0] * NP (the same two chains; t[0] becomes 0), and
// shifts down one limb.
template <class M>
__device__ __forceinline__ void fmul(Fe<M>& r, const Fe<M>& a, const Fe<M>& b) {
  uint32_t t[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t ai = a.v[i];
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
  reduce_once<M>(r.v, t);
}

template <class M>
__device__ __forceinline__ void fsq(Fe<M>& r, const Fe<M>& a) {
  fmul(r, a, a);
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

// r = a^e (Montgomery), e given as 8 limbs, square-and-multiply from the top
// (not inlined: it runs once per inversion, and inlined copies of its loop
// cost minutes of ptxas time)
template <class M>
__device__ __noinline__ void fpow(Fe<M>& r, const Fe<M>& a,
                                     const uint32_t (&e)[8]) {
  Fe<M> acc;
  fset_one(acc);
  for (int i = 255; i >= 0; --i) {
    fsq(acc, acc);
    if ((e[i >> 5] >> (i & 31)) & 1) fmul(acc, acc, a);
  }
  r = acc;
}

// Fermat inverse a^(p-2); 0 -> 0
template <class M>
__device__ __forceinline__ void finv(Fe<M>& r, const Fe<M>& a) {
  uint32_t e[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = M::p(j);
  e[0] -= 2;  // the low limb of either modulus is odd and above 2
  fpow(r, a, e);
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

__device__ __forceinline__ void fsq(Fe2& r, const Fe2& a) { fmul(r, a, a); }

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

// ---------------------------------------------------------------------------
// The curve y^2 = x^3 + b (a = 0) in Jacobian coordinates: x = X/Z^2,
// y = Y/Z^3, infinity is Z = 0. Field-generic: F = Fe<Fq> (G1) or Fe2 (G2).
// The mixed addition, the bucket walk's and the fixed-base loop's step, is
// inlined; the doubling (its rare branch) and the full addition (the
// reductions over buckets and windows) are calls, compiled once each.
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
__device__ __noinline__ void jac_double(Jac<F>& r, const Jac<F>& p) {
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
__device__ __noinline__ void jac_add(Jac<F>& r, const Jac<F>& p,
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

}  // namespace bn254
