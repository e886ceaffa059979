// Poseidon-Goldilocks width-12 permutation over a batch of states, and the
// Merkle commit of a (H, W) source fused onto it (sm_90a). The library
// built from this file also holds the "2d", "mxu", "mxu24", "blocked" and
// "1d" kernels (poseidon_gl_2d.cuh, poseidon_gl_mxu.cuh,
// poseidon_gl_mxu24.cuh, poseidon_gl_blocked.cuh, poseidon_gl_1d.cuh,
// included below): one translation unit, so the lazy body's constant tables
// (poseidon_lazy.cuh) exist once and poseidon_gl_set_constants fills them
// for every kernel. It is the port's only kernel library.
//
// Replaces the TPU kernel zkevm_prover_tpu/ops/poseidon_pallas.py
// _make_kernel_mxu96 (the production "mxu96" mode of poseidon_pallas.permute)
// and, for the commit, the JAX package's fused tree program
// (zkevm_prover_tpu/ops/merkle.py _merkelize_jit, or _leaf_fold_jit +
// _levels_jit on its CPU route: poseidon_gl.linear_hash + hash_level).
// The permutation is 4 full, 22 partial and 4 full rounds of (add round
// constants, x^7 on every lane or on lane 0, the small-integer 12x12 MDS),
// canonical output bit-identical to poseidon_gl.permute. The TPU kernel
// folds the batch onto sublanes as u32 lo/hi planes and runs the MDS as int8
// matmuls on 7-bit limbs; none of that carries over here.
//
// Design: one thread per state, the 12 lanes in u64 registers, and
// everything lazy (any u64 congruent to the value; canonical once, at the
// end), the body in poseidon_lazy.cuh:
//  - field products on 32-bit words with inline-PTX carry chains
//    (goldilocks.cuh mul_lazy / square_lazy / reduce_words);
//  - the MDS with its coefficients compiled in as immediates
//    (poseidon_common.cuh mds_fold_limbs): each lane as limbs of 22, 21
//    and 21 bits, 36 plain 32-bit multiply-adds per output lane, one
//    reduction, and the next round's constant added inside that reduction,
//    so no round but the first adds constants on its own;
//  - the constants of lanes 1..11 of every partial round pushed forward
//    through the (linear) partial rounds into the first full round after
//    them (poseidon_cuda.fold_constants), so a partial round adds one
//    constant, to lane 0;
//  - the partial rounds' MDS factored sparse (the Poseidon paper's
//    appendix B, poseidon_cuda.sparse_constants): 22 full field products
//    per partial round on 5-word carry chains instead of 432 small ones;
//  - rounds in rolled loops, one loop body for all eight full rounds: the
//    kernel is about 4,500 instructions, and unrolled copies ran slower
//    (instruction fetch).
// set_constants refuses a constant set whose MDS is not the compiled-in one.
//
// What bounds it on the H100: integer instruction throughput. A
// permutation is 118 S-boxes (4 field products each: 6-8 IMADs and a
// 13-instruction reduction on the integer ALU), 8 small-integer MDS passes
// of 432 IMADs and the 22 sparse partial rounds, about 30,000 instructions
// in all against 192 bytes of device memory. chip_smoke.poseidon_bound
// counts the S-boxes' IMADs only (the MDS on the tensor cores).
//
// The commit, into one (2H - 1, 4) buffer: merkle_leaf_kernel, a thread
// per row that absorbs one 8-element chunk of the row per launch straight
// from the source (any row and column stride), the row's digest carried in
// the buffer's level 0 between launches; then merkle_level_kernel, one launch
// per level, a thread per parent reading its two children from the buffer,
// while a level has more than 128 parents, and one block for the levels
// above, in shared memory with one barrier per level. No (H, 12) state is
// built in device memory. What the host plans (poseidon_cuda.merkle_plan)
// was measured: one chunk per leaf launch beat a whole row per thread, and
// making log2 128 levels in each leaf block lost to the chunked path (a
// block then holds its registers through seven permutations in a row with
// 64, 32, .. 1 threads busy).
#include <cuda_runtime.h>

#include <cstdint>

#include "poseidon_lazy.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int RATE = 8;
constexpr int HASH = 4;

// One thread per row-major state; Mds is the full rounds' MDS form (kernel
// 1: DenseMds; mode 2d: the circulant form of poseidon_gl_2d.cuh).
template <class Mds>
__global__ void __launch_bounds__(THREADS, 5)
permute_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
               int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n) return;
  // 16-byte loads and stores: a 96-byte state is six of them (the wrapper
  // hands in tensors from the caching allocator, 16-byte aligned)
  const ulonglong2* src = reinterpret_cast<const ulonglong2*>(in + i * WIDTH);
  uint64_t s[WIDTH];
#pragma unroll
  for (int j = 0; j < WIDTH / 2; ++j) {
    const ulonglong2 v = src[j];
    s[2 * j] = v.x;
    s[2 * j + 1] = v.y;
  }
  permute_lazy<Mds>(s);
  ulonglong2* dst = reinterpret_cast<ulonglong2*>(out + i * WIDTH);
#pragma unroll
  for (int j = 0; j < WIDTH / 2; ++j)
    dst[j] = make_ulonglong2(gl::canonical(s[2 * j]),
                             gl::canonical(s[2 * j + 1]));
}

// Offset (in digests) of tree level k in the (2H - 1, 4) buffer: level k
// holds H >> k nodes after the H + H/2 + ... of the levels below it.
__device__ __forceinline__ int64_t level_offset(int64_t h, int k) {
  return 2 * h - 2 * (h >> k);
}

// The rows of the commit: each thread absorbs chunk `chunk` of row `node`
// of the source into that row's digest, kept canonical in level 0 of the
// (2H - 1, 4) tree between launches. Width <= 4: the row zero-padded, as
// given; wider: a sponge of 8-element chunks (the last zero-padded) with
// the previous digest in lanes 8..11, as poseidon_gl.linear_hash.
__global__ void __launch_bounds__(THREADS, 4)
merkle_leaf_kernel(const uint64_t* __restrict__ src, int64_t row_stride,
                   int64_t col_stride, int64_t width,
                   uint64_t* __restrict__ tree, int chunk) {
  const int64_t node = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
  const uint64_t* row = src + node * row_stride;
  uint64_t* digest = tree + node * HASH;
  if (width <= HASH) {
#pragma unroll
    for (int k = 0; k < HASH; ++k)
      digest[k] = k < width ? row[k * col_stride] : 0;
    return;
  }
  uint64_t s[WIDTH] = {};
  if (chunk > 0) {
#pragma unroll
    for (int k = 0; k < HASH; ++k) s[RATE + k] = digest[k];
  }
  const int64_t off = static_cast<int64_t>(chunk) * RATE;
#pragma unroll
  for (int k = 0; k < RATE; ++k)
    s[k] = off + k < width ? row[(off + k) * col_stride] : 0;
  permute_lazy(s);
#pragma unroll
  for (int k = 0; k < HASH; ++k) digest[k] = gl::canonical(s[k]);
}

// The levels of the commit: each thread makes parent `node` of two nodes of
// level `base` read from the tree (level base + 1), then the block reduces
// its blockDim.x parents through `more` = log2(blockDim.x) further levels
// in shared memory, one barrier per level, or none when `more` is 0. The
// parent and level steps share one loop, so the permutation is inlined
// once. Every digest made is written canonical to the tree.
__global__ void __launch_bounds__(THREADS, 4)
merkle_level_kernel(uint64_t* __restrict__ tree, int64_t h, int base,
                    int more) {
  __shared__ uint64_t level_a[THREADS * HASH];      // even levels (0, 2, ..)
  __shared__ uint64_t level_b[THREADS / 2 * HASH];  // odd levels
  const int t = threadIdx.x;
  const int64_t node = static_cast<int64_t>(blockIdx.x) * blockDim.x + t;
  uint64_t s[WIDTH];
  for (int level = 0; level <= more; ++level) {   // above base + 1
    bool active = true;
    if (level == 0) {
      const uint64_t* kids = tree + (level_offset(h, base) + 2 * node) * HASH;
#pragma unroll
      for (int k = 0; k < 2 * HASH; ++k) s[k] = kids[k];
    } else {
      __syncthreads();  // the level below is in shared memory
      active = t < static_cast<int>(blockDim.x >> level);
      if (active) {
        const uint64_t* below = (level & 1) ? level_a : level_b;
#pragma unroll
        for (int k = 0; k < 2 * HASH; ++k) s[k] = below[2 * t * HASH + k];
      }
    }
#pragma unroll
    for (int k = 2 * HASH; k < WIDTH; ++k) s[k] = 0;
    if (active) {
      permute_lazy(s);
      uint64_t* above = (level & 1) ? level_b : level_a;
      const int64_t at = level_offset(h, base + 1 + level) +
                         static_cast<int64_t>(blockIdx.x) *
                             (blockDim.x >> level) + t;
#pragma unroll
      for (int k = 0; k < HASH; ++k) {
        const uint64_t v = gl::canonical(s[k]);
        above[t * HASH + k] = v;
        tree[at * HASH + k] = v;
      }
    }
  }
}

}  // namespace

// The library's other five permutation kernels, on the same lazy body.
#include "poseidon_gl_2d.cuh"
#include "poseidon_gl_mxu.cuh"
#include "poseidon_gl_mxu24.cuh"
#include "poseidon_gl_blocked.cuh"
#include "poseidon_gl_1d.cuh"

// Load the constant set for every kernel of the library: rc0 the 12
// constants of round 0, fold the 30 x 12 constants added after each round's
// MDS (poseidon_cuda.fold_constants), mds the set's 12x12 MDS row-major and
// circ, diag its circulant + diagonal decomposition (poseidon_cuda
// .circ_diag), which must be the compiled-in ones, pre, w, v the sparse
// partial rounds (poseidon_cuda.sparse_constants), mxu_b mode mxu's
// (32, 16) u8 operand and mxu24_b mode mxu24's (32, 24) one
// (poseidon_cuda.mma_operands).
// Returns a cudaError_t code, or POSEIDON_GL_MDS_MISMATCH.
#define POSEIDON_GL_MDS_MISMATCH (-1)
extern "C" int poseidon_gl_set_constants(const uint64_t* rc0,
                                         const uint64_t* fold,
                                         const uint32_t* mds,
                                         const uint32_t* circ,
                                         const uint32_t* diag,
                                         const uint64_t* pre,
                                         const uint64_t* w,
                                         const uint64_t* v,
                                         const uint8_t* mxu_b,
                                         const uint8_t* mxu24_b) {
  for (int i = 0; i < WIDTH; ++i) {
    if (circ[i] != pos::circ_coeff(i) || diag[i] != pos::diag_coeff(i))
      return POSEIDON_GL_MDS_MISMATCH;
    for (int j = 0; j < WIDTH; ++j)
      if (mds[i * WIDTH + j] != pos::mds_coeff(i, j))
        return POSEIDON_GL_MDS_MISMATCH;
  }
  cudaError_t err = cudaMemcpyToSymbol(RC0, rc0, sizeof(RC0));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(FOLD, fold, sizeof(FOLD));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(SP_PRE, pre, sizeof(SP_PRE));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(SP_W, w, sizeof(SP_W));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(SP_V, v, sizeof(SP_V));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(mxu::MXU_B, mxu_b, sizeof(mxu::MXU_B));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(mxu24::MXU24_B, mxu24_b, sizeof(mxu24::MXU24_B));
  return static_cast<int>(err);
}

// out[i] = permute(in[i]) for n row-major (n, 12) uint64 states (16-byte
// aligned), launched on `stream`. Returns cudaGetLastError() after the launch.
extern "C" int poseidon_gl_permute(const uint64_t* in, uint64_t* out,
                                   long long n, void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + THREADS - 1) / THREADS;
  permute_kernel<DenseMds><<<static_cast<unsigned>(blocks), THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(in, out, n);
  return static_cast<int>(cudaGetLastError());
}

// One launch of the commit into the (2H - 1, 4) buffer `tree`: `nodes`
// threads in blocks of `threads` (a power of two, <= 128, dividing nodes),
// each making one digest (leaves != 0: chunk `chunk` of a row of the
// (H, width) source, element strides row_stride and col_stride; else a
// parent of level `base`), then `more` levels in each block (0, or log2
// threads). Returns cudaGetLastError() after the launch.
extern "C" int poseidon_gl_merkle(const uint64_t* src, long long row_stride,
                                  long long col_stride, long long width,
                                  uint64_t* tree, long long h, int base,
                                  int leaves, long long nodes, int threads,
                                  int more, int chunk, void* stream) {
  if (threads < 1 || threads > THREADS || (threads & (threads - 1)) ||
      nodes % threads || (more != 0 && (1 << more) != threads) ||
      (leaves && more != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(nodes / threads));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (leaves) {
    merkle_leaf_kernel<<<grid, threads, 0, st>>>(src, row_stride, col_stride,
                                                 width, tree, chunk);
  } else {
    merkle_level_kernel<<<grid, threads, 0, st>>>(tree, h, base, more);
  }
  return static_cast<int>(cudaGetLastError());
}
