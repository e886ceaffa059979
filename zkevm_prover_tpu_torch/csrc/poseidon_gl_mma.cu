// Poseidon-Goldilocks permutation with the MDS on the tensor cores (sm_90a).
//
// Replaces two TPU kernels of zkevm_prover_tpu/ops/poseidon_pallas.py:
//  * _make_kernel_mxu ("mxu"): state (12, B); the MDS as one bf16 MXU matmul
//    over the 8 byte planes of the state, A = I_8 (x) M padded to 128, the
//    products recombined as sum_t R_t 2^(8t) with the next round's constant
//    folded into the accumulator seed;
//  * _make_kernel_mxu24 ("mxu24"): two batch halves stacked (24, B),
//    A = I_8 (x) blockdiag(M, M), adjacent byte planes paired carry-free
//    (G_q = R_2q + R_2q+1 2^8) before the recombination, a lazy
//    (non-canonical) S-box and one canonicalisation at the end.
// Both compute the permutation bit-identically to poseidon_gl.permute_plain.
//
// Design: a warp owns 32 states, one per thread for the S-boxes and the
// recombination (the 12 lanes in u64 registers). For the MDS the warp
// writes the states' byte planes to shared memory and runs
// mma.sync.m16n8k32 (u8 x u8 -> s32) on them: exact, since
// 12 * 41 * 255 < 2^17 fits s32. The products go back through shared memory
// to the owning thread, which recombines them into 128 bits with the next
// round's constant and reduces. Round 0's constant is added first and c_30
// is zero, as in the TPU kernels.
//  * kMxu: A = M padded to 16 x 32 (a fixed register fragment), B = one byte
//    plane of 8 states (k = input lane). One MMA per 8 states per plane:
//    30 rounds x 8 planes / 8 states = 30 MMAs per permutation; useful
//    products 8 x 144 of 16 x 8 x 32 = 28.1 %.
//  * kMxu24: A = one byte-plane PAIR of 16 states, the two planes side by
//    side in k (12 + 12 of 32), B = blockdiag(M^T, M^T) (a fixed fragment,
//    n = 24 in three n8 tiles), so one m16 tile and three MMAs cover 16
//    states x 2 planes: 30 x 4 pairs x 3 / 16 = 22.5 MMAs per permutation;
//    useful 2 x 16 x 144 of 3 x 4096 = 37.5 %. The paired planes come out
//    side by side, so the recombination pairs them carry-free.
//
// What bounds it on the H100: still the integer multiplies of the 118
// S-boxes (the MDS was a third of the IMADs); the tensor cores take the MDS
// off the CUDA cores at the price of two shared-memory round trips per
// round. Shared memory: 17,024 bytes per warp, 2 warps per block.
#include <cuda_runtime.h>

#include <cstdint>

#include "poseidon_common.cuh"

namespace {

constexpr int WARPS = 2;
constexpr int THREADS = 32 * WARPS;
constexpr int XS = 36;   // words per state of byte planes (= 4 mod 32)
constexpr int RS = 97;   // words per state of MMA results (odd)

__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(0));
}

__device__ __forceinline__ uint32_t byte_of(uint64_t v, int plane) {
  return static_cast<uint32_t>(v >> (8 * plane)) & 0xFFu;
}

// Four lanes' byte `plane`, lane `first` in the lowest byte.
__device__ __forceinline__ uint32_t pack4(const uint64_t s[pos::WIDTH],
                                          int first, int plane) {
  return byte_of(s[first], plane) | (byte_of(s[first + 1], plane) << 8) |
         (byte_of(s[first + 2], plane) << 16) |
         (byte_of(s[first + 3], plane) << 24);
}

// The fixed MMA operands, u8, filled by poseidon_gl_mma_set_constants from
// the host tables of ops/poseidon_cuda.mma_operands: kMxu's A = M padded to
// 16 x 32 (row = output lane, column = input lane), kMxu24's
// B = blockdiag(M^T, M^T) padded to 32 x 24 (row = k, column = n).
__constant__ uint8_t OP_A[16 * 32];
__constant__ uint8_t OP_B[32 * 24];

// c + lo_part + hi_part * 2^32 (each part < 2^45) as a 128-bit (hi, lo).
__device__ __forceinline__ void recombine(uint64_t c, uint64_t lo_part,
                                          uint64_t hi_part, uint64_t& hi,
                                          uint64_t& lo) {
  lo = c + lo_part;
  hi = lo < lo_part ? 1 : 0;
  uint64_t t = hi_part << 32;
  lo += t;
  hi += (lo < t ? 1 : 0) + (hi_part >> 32);
}

template <bool kMxu24>
__global__ void __launch_bounds__(THREADS)
permute_mma_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                   int64_t b) {
  __shared__ __align__(16) uint32_t xs_all[WARPS * 32 * XS];  // uint4 stores
  __shared__ uint32_t rs_all[WARPS * 32 * RS];
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;        // MMA fragment group
  const int t = lane & 3;         // thread in group
  uint32_t* xs = xs_all + (threadIdx.x >> 5) * 32 * XS;
  uint32_t* rs = rs_all + (threadIdx.x >> 5) * 32 * RS;

  // The fixed MMA operand: M for kMxu (A, 16 x 32), blockdiag(M^T, M^T)
  // for kMxu24 (B, 32 x 24 as three n8 tiles).
  // A fragment: rows g, g+8; columns 4t..4t+3 and 16+4t..16+4t+3.
  // B fragment: column g of the n8 tile; rows 4t..4t+3 and 16+4t..16+4t+3.
  uint32_t fa[4] = {0, 0, 0, 0};
  uint32_t fb[3][2] = {{0, 0}, {0, 0}, {0, 0}};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if constexpr (!kMxu24) {
      fa[0] |= uint32_t{OP_A[g * 32 + 4 * t + c]} << (8 * c);
      fa[1] |= uint32_t{OP_A[(g + 8) * 32 + 4 * t + c]} << (8 * c);
      fa[2] |= uint32_t{OP_A[g * 32 + 16 + 4 * t + c]} << (8 * c);
      fa[3] |= uint32_t{OP_A[(g + 8) * 32 + 16 + 4 * t + c]} << (8 * c);
    } else {
#pragma unroll
      for (int nt = 0; nt < 3; ++nt) {
        fb[nt][0] |= uint32_t{OP_B[(4 * t + c) * 24 + nt * 8 + g]} << (8 * c);
        fb[nt][1] |= uint32_t{OP_B[(16 + 4 * t + c) * 24 + nt * 8 + g]}
                     << (8 * c);
      }
    }
  }

  // this thread's state: (12, b) lane-major for kMxu; for kMxu24 the two
  // halves stacked as (24, b/2), state i of half h at column i - h * b/2
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const uint64_t* src;
  uint64_t* dst;
  int64_t stride;
  if constexpr (!kMxu24) {
    src = in + i;
    dst = out + i;
    stride = b;
  } else {
    const int64_t cols = b / 2;
    const int64_t h = i / cols;
    src = in + h * pos::WIDTH * cols + (i - h * cols);
    dst = out + h * pos::WIDTH * cols + (i - h * cols);
    stride = cols;
  }
  uint64_t s[pos::WIDTH];
#pragma unroll
  for (int j = 0; j < pos::WIDTH; ++j) {
    s[j] = gl::add(gl::canonical(src[j * stride]), pos::RC[j]);
  }

#pragma unroll 1
  for (int r = 0; r < pos::N_ROUNDS; ++r) {
    const bool full = r < pos::HALF_F || r >= pos::HALF_F + pos::ROUNDS_P;
    if constexpr (!kMxu24) {
      if (full) {
#pragma unroll
        for (int j = 0; j < pos::WIDTH; ++j) s[j] = pos::sbox(s[j]);
      } else {
        s[0] = pos::sbox(s[0]);
      }
    } else {
      if (full) {
#pragma unroll
        for (int j = 0; j < pos::WIDTH; ++j) s[j] = pos::sbox_lazy(s[j]);
      } else {
        s[0] = pos::sbox_lazy(s[0]);
      }
    }

    // byte planes -> shared memory
    uint32_t* mine = xs + lane * XS;
    if constexpr (!kMxu24) {
      // plane p: words of lanes 0-3, 4-7, 8-11, and a zero (k 12..15)
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        *reinterpret_cast<uint4*>(mine + 4 * p) =
            make_uint4(pack4(s, 0, p), pack4(s, 4, p), pack4(s, 8, p), 0u);
      }
    } else {
      // plane pair q: k 0..11 plane 2q, k 12..23 plane 2q+1, k 24..31 zero
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        *reinterpret_cast<uint4*>(mine + 8 * q) = make_uint4(
            pack4(s, 0, 2 * q), pack4(s, 4, 2 * q), pack4(s, 8, 2 * q),
            pack4(s, 0, 2 * q + 1));
        *reinterpret_cast<uint4*>(mine + 8 * q + 4) = make_uint4(
            pack4(s, 4, 2 * q + 1), pack4(s, 8, 2 * q + 1), 0u, 0u);
      }
    }
    __syncwarp();

    // the MDS products on the tensor cores -> shared memory
    int d[4];
    if constexpr (!kMxu24) {
      // D (16 x 8): row = output lane, column = state of the n8 tile
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          mma_u8(d, fa, xs[(nt * 8 + g) * XS + 4 * p + t], 0u);
          uint32_t* r0 = rs + (nt * 8 + 2 * t) * RS + p * pos::WIDTH;
          r0[g] = d[0];
          r0[RS + g] = d[1];
          if (g < 4) {
            r0[g + 8] = d[2];
            r0[RS + g + 8] = d[3];
          }
        }
      }
    } else {
      // D (16 x 8): row = state of the m16 tile, column = 8 of the 24
      // outputs (12 lanes of plane 2q, then 12 of plane 2q+1)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t* x0 = xs + (mt * 16 + g) * XS + 8 * q;
          const uint32_t a[4] = {x0[t], x0[8 * XS + t], x0[4 + t],
                                 x0[8 * XS + 4 + t]};
#pragma unroll
          for (int nt = 0; nt < 3; ++nt) {
            mma_u8(d, a, fb[nt][0], fb[nt][1]);
            uint32_t* r0 = rs + (mt * 16 + g) * RS + 24 * q + nt * 8 + 2 * t;
            r0[0] = d[0];
            r0[1] = d[1];
            r0[8 * RS] = d[2];
            r0[8 * RS + 1] = d[3];
          }
        }
      }
    }
    __syncwarp();

    // recombine this thread's products with the next round's constant
    const uint32_t* rm = rs + lane * RS;
    const bool last = r == pos::N_ROUNDS - 1;
#pragma unroll
    for (int j = 0; j < pos::WIDTH; ++j) {
      uint64_t lo_part, hi_part;
      if constexpr (!kMxu24) {
        // sum_p R_p 2^(8p): planes 0-3 below 2^32, planes 4-7 above
        lo_part = static_cast<uint64_t>(rm[j]) +
                  (static_cast<uint64_t>(rm[12 + j]) << 8) +
                  (static_cast<uint64_t>(rm[24 + j]) << 16) +
                  (static_cast<uint64_t>(rm[36 + j]) << 24);
        hi_part = static_cast<uint64_t>(rm[48 + j]) +
                  (static_cast<uint64_t>(rm[60 + j]) << 8) +
                  (static_cast<uint64_t>(rm[72 + j]) << 16) +
                  (static_cast<uint64_t>(rm[84 + j]) << 24);
      } else {
        // G_q = R_2q + R_2q+1 2^8 (< 2^26, carry-free); sum_q G_q 2^(16q)
        uint64_t gq[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          gq[q] = static_cast<uint64_t>(rm[24 * q + j]) +
                  (static_cast<uint64_t>(rm[24 * q + 12 + j]) << 8);
        }
        lo_part = gq[0] + (gq[1] << 16);
        hi_part = gq[2] + (gq[3] << 16);
      }
      const uint64_t c = last ? 0 : pos::RC[(r + 1) * pos::WIDTH + j];
      uint64_t hi, lo;
      recombine(c, lo_part, hi_part, hi, lo);
      if constexpr (!kMxu24) {
        s[j] = gl::reduce128(hi, lo);
      } else {
        s[j] = pos::reduce128_lazy(hi, lo);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < pos::WIDTH; ++j) dst[j * stride] = gl::canonical(s[j]);
}

}  // namespace

// Copy the constant set into __constant__ memory (pos::set_constants) and
// the two u8 MMA operands (16 x 32 and 32 x 24, row-major).
extern "C" int poseidon_gl_mma_set_constants(const uint64_t* rc,
                                             const uint32_t* mds,
                                             const uint32_t* circ,
                                             const uint32_t* diag,
                                             const uint8_t* op_a,
                                             const uint8_t* op_b) {
  int err = pos::set_constants(rc, mds, circ, diag);
  if (err) return err;
  cudaError_t e = cudaMemcpyToSymbol(OP_A, op_a, sizeof(OP_A));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(OP_B, op_b, sizeof(OP_B));
  return static_cast<int>(e);
}

// Permute b uint64 states, b a multiple of 2 * 64 (each warp full, each
// half of whole warps): mxu24 = 0 takes and returns the (12, b) lane-major
// layout, mxu24 = 1 the two halves stacked as (24, b/2). Launched on
// `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a bad b).
extern "C" int poseidon_gl_mma_permute(const uint64_t* in, uint64_t* out,
                                       long long b, int mxu24, void* stream) {
  if (b <= 0) return 0;
  if (b % (2 * THREADS)) return static_cast<int>(cudaErrorInvalidValue);
  unsigned blocks = static_cast<unsigned>(b / THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mxu24) {
    permute_mma_kernel<true><<<blocks, THREADS, 0, st>>>(in, out, b);
  } else {
    permute_mma_kernel<false><<<blocks, THREADS, 0, st>>>(in, out, b);
  }
  return static_cast<int>(cudaGetLastError());
}
