// Poseidon-Goldilocks permutation, mode "2d": (H, 12) row-major states with
// the full rounds' MDS in its circulant + diagonal form, the circulant part
// in the frequency domain (sm_90a).
//
// Replaces the TPU kernel zkevm_prover_tpu/ops/poseidon_pallas.py
// _make_kernel_2d (mode "2d" of poseidon_pallas.permute). That kernel holds
// the batch as (12, TB=512) lane-major tiles, so that one VPU op covers the
// whole state, and applies the MDS as 12 sublane-rotated terms plus one
// masked diagonal term (_circ_diag): out_i = sum_k circ_k s_((i+k)%12) +
// diag_i s_i. The lane-major tile served the TPU's sublanes; here it would
// only cost two transposes, so the kernel reads the (H, 12) states as kernel
// 1 does.
//
// Design: kernel 1's row-major kernel (poseidon_gl.cu permute_kernel: one
// thread per state, 16-byte loads and stores, any H) on the lazy body of
// poseidon_lazy.cuh, with the full rounds' MDS in the TPU kernel's
// decomposition, on the 22/21/21-bit limbs, the fold constant added inside
// the one reduction:
//  - the circulant part as a cyclic convolution of length 12 = 3 x 4 (lane
//    i as (i mod 3, i mod 4), the CRT): a length-4 real DFT on each residue
//    class mod 3, 3-point cyclic products in each frequency, the inverse
//    DFT. Its constants come from circ_coeff at compile time, with the
//    inverse DFT's 1/4 and 1/2 folded in: F0/4 = (16, 16, 32),
//    F2/4 = (-1, 2, 8), F1/2 = (2 + i, -16 + i, -1 + 4i), each checked
//    exact (static_assert), so nothing divides at run time. Every product
//    is by a small power of two up to sign and ±1, so the form is adds,
//    shifts and LEAs on the integer ALU: about 90 per limb array against
//    the dense form's 144 multiply-adds. Every intermediate stays below 2^30
//    in magnitude on 22-bit limbs (the CPU model of
//    tests/test_torch_poseidon_tables.py bounds each), and u32 wrap-around
//    arithmetic is exact for this integer-linear map in any case;
//  - the diagonal (lane 0's +8, diag_coeff) as one more multiply-add;
//  - poseidon_gl_set_constants checks the constant set's decomposition
//    (poseidon_cuda.circ_diag) against the one compiled in, so another
//    MDS, or one of another shape, is refused.
// Against the dense immediates (kernel 1's form) it measured 12 % faster
// on the H100 at 2^22 states, with 7.6 % fewer instructions (PERF.md).
//
// What bounds it on the H100: integer instruction throughput, as kernel 1
// (about 27,600 instructions per permutation, 192 bytes of device memory).
//
// Part of the poseidon_gl library: poseidon_gl.cu includes this file after
// its permute_kernel.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "poseidon_lazy.cuh"

namespace {
namespace circulant {

// lane i of the state as (i mod 3, i mod 4)
__host__ __device__ constexpr int crt(int a, int b) {
  return (4 * a + 9 * b) % WIDTH;
}

// F_f[a] = sum_b circ(crt(a, b)) i^(f b), a Gaussian integer: part 0 its
// real part, part 1 its imaginary part.
__host__ __device__ constexpr int freq(int f, int a, int part) {
  int sum = 0;
  for (int b = 0; b < 4; ++b) {
    const int e = (f * b + 4 - part) % 4;   // i^(f b) = i^part * (+-1)
    const int c = static_cast<int>(pos::circ_coeff(crt(a, b)));
    sum += e == 0 ? c : e == 2 ? -c : 0;
  }
  return sum;
}
__host__ __device__ constexpr int f0(int a) { return freq(0, a, 0) / 4; }
__host__ __device__ constexpr int f2(int a) { return freq(2, a, 0) / 4; }
__host__ __device__ constexpr int f1r(int a) { return freq(1, a, 0) / 2; }
__host__ __device__ constexpr int f1i(int a) { return freq(1, a, 1) / 2; }

constexpr bool freq_exact() {
  for (int a = 0; a < 3; ++a) {
    if (freq(0, a, 0) % 4 || freq(2, a, 0) % 4 || freq(1, a, 0) % 2 ||
        freq(1, a, 1) % 2 || freq(0, a, 1) || freq(2, a, 1))
      return false;
  }
  return true;
}
static_assert(freq_exact(), "the circulant's DFT constants must divide");

// y = circ x on one limb array, in the frequency domain (u32, exact).
__device__ __forceinline__ void circ_freq(const uint32_t x[WIDTH],
                                          uint32_t y[WIDTH]) {
  uint32_t s0[3], s2[3], s1r[3], s1i[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const uint32_t e0 = x[crt(a, 0)] + x[crt(a, 2)];
    const uint32_t e1 = x[crt(a, 1)] + x[crt(a, 3)];
    s0[a] = e0 + e1;                        // sum_b x_b
    s2[a] = e0 - e1;                        // sum_b x_b (-1)^b
    s1r[a] = x[crt(a, 0)] - x[crt(a, 2)];   // sum_b x_b (-i)^b
    s1i[a] = x[crt(a, 3)] - x[crt(a, 1)];
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    uint32_t t0 = 0, t2 = 0, t1r = 0, t1i = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int j = (a + k) % 3;
      t0 += static_cast<uint32_t>(f0(k)) * s0[j];
      t2 += static_cast<uint32_t>(f2(k)) * s2[j];
      t1r += static_cast<uint32_t>(f1r(k)) * s1r[j] -
             static_cast<uint32_t>(f1i(k)) * s1i[j];
      t1i += static_cast<uint32_t>(f1r(k)) * s1i[j] +
             static_cast<uint32_t>(f1i(k)) * s1r[j];
    }
    const uint32_t u = t0 + t2, v = t0 - t2;
    y[crt(a, 0)] = u + t1r;   // out_b = T0 + (-1)^b T2 + Re(i^b T1)
    y[crt(a, 1)] = v - t1i;
    y[crt(a, 2)] = u - t1r;
    y[crt(a, 3)] = v + t1i;
  }
}

// s <- (circ + diag) s + c on the 22/21/21-bit limbs, lazy in and out.
struct Mds {
  __device__ __forceinline__ void operator()(uint64_t s[WIDTH],
                                             const uint64_t* c) const {
    uint32_t l0[WIDTH], l1[WIDTH], l2[WIDTH];
    pos::split_limbs(s, l0, l1, l2);
    uint32_t y0[WIDTH], y1[WIDTH], y2[WIDTH];
    circ_freq(l0, y0);
    circ_freq(l1, y1);
    circ_freq(l2, y2);
#pragma unroll
    for (int i = 0; i < WIDTH; ++i)
      s[i] = pos::fold_limb_sums(y0[i] + l0[i] * pos::diag_coeff(i),
                                 y1[i] + l1[i] * pos::diag_coeff(i),
                                 y2[i] + l2[i] * pos::diag_coeff(i), c[i]);
  }
};

}  // namespace circulant
}  // namespace

// out[i] = permute(in[i]) for n row-major (n, 12) uint64 states (16-byte
// aligned), any n, launched on `stream`. Returns cudaGetLastError() after
// the launch.
extern "C" int poseidon_gl_2d_permute(const uint64_t* in, uint64_t* out,
                                      long long n, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + THREADS - 1) / THREADS;
  permute_kernel<circulant::Mds><<<static_cast<unsigned>(blocks), THREADS, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      in, out, n);
  return static_cast<int>(cudaGetLastError());
}
