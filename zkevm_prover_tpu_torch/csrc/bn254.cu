// The BN254 kernels of the SNARK wrap (sm_90a), one library with a plain C
// interface (ops/bn254_cuda.py binds it with ctypes), on csrc/bn254.cuh.
//
// What each replaces, and what bounds it on this card:
//  - msm_count_kernel, msm_scan_*_kernel, msm_scatter_kernel,
//    msm_bucket_kernel, msm_tree_kernel, msm_reduce_kernel,
//    msm_window_kernel, msm_horner_kernel: the Pippenger MSM over G1 (Fp)
//    and G2 (Fp2), the port of zkevm_prover_tpu/ops/bn254_device.py
//    _msm_device :390 (with _all_window_digits :298,
//    _segmented_bucket_sums :348 and _bucket_reduce :380), which XLA fuses
//    on the TPU, where a log-depth segmented scan of the group law stands
//    in for a serial loop. Here, for the card:
//    * signed c-bit digits (|d| <= 2^(c-1), a negative one adds -P: y
//      becomes p - y at load), so a window has 2^(c-1) buckets; c is the
//      least of the cost model n * (254/c + 1) mixed additions against
//      2^c (254/c + 1) full ones (ops/bn254_device.py msm_window);
//    * the bucket sort on the card with no host sync: a histogram of
//      (window, |digit|) with warp-aggregated atomics, a three-kernel
//      exclusive scan, a scatter of 32-bit point indices with the sign in
//      bit 31, a window at a time. Every launch's size is fixed from n;
//    * equal chunks of L places over the whole sorted order, one thread
//      each, whatever the buckets: a thread's mixed additions follow one
//      another (each needs the last), so a skewed bucket (a witness's 0/1
//      digits hold half the points) is spread over many threads, and the
//      buckets that span chunks are joined by radix-4 tree passes. The
//      next point is copied into a shared-memory ring (cp.async, 16-byte
//      pieces) while the thread adds the last one;
//    * the reduction over the whole card: each window's buckets are cut
//      into runs of Ls, one thread each (the running-sum trick, lifted by
//      the run's offset with a double-and-add), a tree in shared memory per
//      block, then per window;
//    * the Horner pass over the windows: one thread, about 254 Jacobian
//      doublings in a row, the one serial part left.
//    The buckets and sums are XYZZ (bn254.cuh): 10 products a mixed
//    addition and 14 a full one, against Jacobian's 11 and 16. The field
//    arithmetic stays the CIOS of bn254.cuh on the integer pipes: a
//    256-bit Montgomery product is 64 32-bit limb products and carry
//    chains, which the tensor cores (8-bit and floating-point products
//    summed without carries) do not give in a simple design.
//    Bound: operations, the least over c of a mixed addition per nonzero
//    signed digit and 2^c (254/c + 1) full additions (chip_smoke.py
//    msm_bound).
//  - fb_table_kernel, fb_normalize_kernel, fixed_base_kernel: k * G1 and
//    k * G2 for a batch of scalars, what groth16_setup's loops compute one
//    at a time on the host (zkevm_prover_tpu/snark/groth16.py:89-119
//    through ops/bn254.py g1_mul_gen :434 / g2_mul_gen :532). The
//    generator's table for signed c-bit digits (d 2^(c j) G for
//    d = 1 .. 2^(c-1), one row a window; c from the cost model
//    ops/bn254_cuda.py fixed_base_plan) is built on the card (runs of
//    entries a thread, then one batch inversion a block) and cached by the
//    wrapper; each thread then takes one scalar (its 32 bytes with 16-byte
//    loads), adds one entry per nonzero digit in XYZZ coordinates (10
//    products a mixed addition, 28 over Fp2) and the block normalises its
//    points with one inversion (a product tree in shared memory,
//    block_affine). Batch-affine additions (6 products, 17 over Fp2)
//    would need an inversion per window step across a batch: one per
//    block costs a lone lane about 45 products' instructions and tens of
//    microseconds of latency a step, one per grid a pass over the
//    accumulators in device memory a step. Bound: operations, the least
//    over c of batch-affine additions per nonzero digit and the table's
//    build (chip_smoke.py fixed_base_bound).
//  - fr_powers_kernel (cached tables) and fr_ntt_pass_kernel (the
//    fr_ntt chain) and fr_pointwise_kernel: bn254.fr_fft (ops/bn254.py:590)
//    over the scalar field, forward and inverse, natural order in and
//    out, with an optional coset shift x_i * g^i before it and y_i * h^i
//    after it, and the quotient's pointwise (a * b - c) * z (groth16.py
//    _quotient_coeffs :123). The transform is the four-step (Bailey)
//    decomposition into at most three passes over the array
//    (ops/bn254_device.py ntt_plan: 2^21 and 2^22 take two), each a set of
//    sub-transforms of up to 2^11 points in shared memory with every
//    radix-2 stage, the twist between passes fused into a pass's store, the
//    bit reversal into the tile's load; the elements stay in ordinary form
//    (Montgomery factors), and the shift, the post and the inverse's 1/n
//    ride on the first load and the last store, their powers the product of
//    two cached tables of about sqrt(n) entries. Bound: operations, (n/2)
//    log n butterflies of one product, one more an element for each factor
//    and each power series (chip_smoke.py ntt_bound).
//
// Every point or element crosses the interface as 32-bit limbs in
// ordinary (not Montgomery) form: a G1 point (x, y) 16 words, a G2 point
// (x.c0, x.c1, y.c0, y.c1) 32 words; the point at infinity is all zeros
// ((0, 0) is on neither curve). Scalars are 8 words, below 2^256.
#include <cuda_runtime.h>

#include <cstdint>

#include "bn254.cuh"

// One group per library, so that the two build in parallel: this file
// alone is the G1 library with the Fr kernels (`bn254`); csrc/bn254_g2.cu
// defines BN254_G2 and includes it for the G2 library (`bn254_g2`).
#ifndef BN254_G2
#define BN254_G2 0
#endif

using namespace bn254;

namespace {

constexpr int THREADS = 256;
constexpr int FB_RUN = 32;          // table entries a thread of the build
constexpr int NTT_TILE_LOG = 11;    // a pass's largest sub-transform
constexpr int NTT_PLAN = 10;        // int64 fields of a pass in the plan

struct U8 {
  uint32_t v[8];
};

using G1F = Fe<Fq>;
using G2F = Fe2;
using FrE = Fe<Fr>;

template <class F>
__host__ __device__ constexpr int words() {
  return sizeof(F) / 4;
}

__device__ __forceinline__ void load(G1F& a, const uint32_t* p) {
#pragma unroll
  for (int j = 0; j < 8; ++j) a.v[j] = p[j];
}
__device__ __forceinline__ void load(G2F& a, const uint32_t* p) {
  load(a.c0, p);
  load(a.c1, p + 8);
}
__device__ __forceinline__ void load(FrE& a, const uint32_t* p) {
#pragma unroll
  for (int j = 0; j < 8; ++j) a.v[j] = p[j];
}
__device__ __forceinline__ void store(uint32_t* p, const G1F& a) {
#pragma unroll
  for (int j = 0; j < 8; ++j) p[j] = a.v[j];
}
__device__ __forceinline__ void store(uint32_t* p, const G2F& a) {
  store(p, a.c0);
  store(p + 8, a.c1);
}
__device__ __forceinline__ void store(uint32_t* p, const FrE& a) {
#pragma unroll
  for (int j = 0; j < 8; ++j) p[j] = a.v[j];
}
__device__ __forceinline__ void mont_in(G1F& a) { to_mont(a, a); }
__device__ __forceinline__ void mont_in(G2F& a) {
  to_mont(a.c0, a.c0);
  to_mont(a.c1, a.c1);
}
__device__ __forceinline__ void mont_out(G1F& a) { from_mont(a, a); }
__device__ __forceinline__ void mont_out(G2F& a) {
  from_mont(a.c0, a.c0);
  from_mont(a.c1, a.c1);
}

// the affine point in ordinary form, zeros for infinity
template <class F>
__device__ __forceinline__ void store_affine(uint32_t* dst, const Jac<F>& p) {
  F x, y;
  if (fis_zero(p.Z)) {
    fset_zero(x);
    fset_zero(y);
  } else {
    F zi, z2;
    finv(zi, p.Z);
    fsq(z2, zi);
    fmul(x, p.X, z2);
    fmul(z2, z2, zi);
    fmul(y, p.Y, z2);
    mont_out(x);
    mont_out(y);
  }
  store(dst, x);
  store(dst + words<F>(), y);
}

__device__ __forceinline__ int64_t thread_id() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

int blocks_for(int64_t n, int threads = THREADS) {
  return static_cast<int>((n + threads - 1) / threads);
}

// ---------------------------------------------------------------------------
// MSM
// ---------------------------------------------------------------------------

constexpr int MSM_THREADS = 128;     // bucket and tree blocks
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ITEMS = 4;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;
constexpr uint32_t NO_KEY = 0xffffffffu;
constexpr uint32_t NEG = 0x80000000u;  // a sorted entry's sign bit

// N words (a multiple of 4) from 16-byte aligned device memory
template <int N>
__device__ __forceinline__ void ld16(uint32_t (&w)[N], const uint32_t* p) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const uint4 u = v[j];
    w[4 * j] = u.x;
    w[4 * j + 1] = u.y;
    w[4 * j + 2] = u.z;
    w[4 * j + 3] = u.w;
  }
}

template <int N>
__device__ __forceinline__ void st16(uint32_t* p, const uint32_t (&w)[N]) {
  uint4* v = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
    v[j] = make_uint4(w[4 * j], w[4 * j + 1], w[4 * j + 2], w[4 * j + 3]);
}

template <class F>
__device__ __forceinline__ void store_xyzz(uint32_t* dst, const Xyzz<F>& p) {
  constexpr int W = words<F>();
  uint32_t w[4 * W];
  store(w, p.X);
  store(w + W, p.Y);
  store(w + 2 * W, p.ZZ);
  store(w + 3 * W, p.ZZZ);
  st16(dst, w);
}

// The signed c-bit digits of a scalar below 2^254, low window first:
// d_w = v - 2^c with a carry into the next window when v = raw_w + carry
// is above 2^(c-1), else d_w = v, so that sum d_w 2^(c w) = s with every
// |d_w| <= 2^(c-1) (c <= 31). The words move down the register array as
// the windows pass them, so that no word is read by a computed index.
struct SignedDigits {
  uint32_t s[8];
  int off = 0;
  uint32_t carry = 0;

  __device__ __forceinline__ uint32_t next(int c, bool& neg) {
    const uint32_t mask = (1u << c) - 1;
    const uint32_t v = (__funnelshift_r(s[0], s[1], off) & mask) + carry;
    off += c;
    if (off >= 32) {
#pragma unroll
      for (int j = 0; j < 7; ++j) s[j] = s[j + 1];
      s[7] = 0;
      off -= 32;
    }
    neg = v > (mask >> 1) + 1;
    carry = neg;
    return neg ? mask + 1 - v : v;
  }
};

// Per point: its Montgomery form (pts_mont), whether it is the point at
// infinity (inf), and its nonzero digits counted into the histogram of
// (window, |digit|) buckets, counts[w * 2^(c-1) + |d| - 1]. Lanes of a
// warp that hit one bucket add once (__match_any_sync), so that a bucket
// that most scalars share (a witness's 0/1 digits) takes one atomic a
// warp.
template <class F>
__global__ void __launch_bounds__(THREADS)
    msm_count_kernel(const uint32_t* __restrict__ pts,
                     const uint32_t* __restrict__ scalars, int64_t n, int c,
                     int nwin, uint32_t* __restrict__ pts_mont,
                     uint8_t* __restrict__ inf, uint32_t* __restrict__ counts) {
  constexpr int W = words<F>();
  const int64_t i = thread_id();
  bool live = false;
  SignedDigits dg;
#pragma unroll
  for (int j = 0; j < 8; ++j) dg.s[j] = 0;
  if (i < n) {
    uint32_t w[2 * W];
    ld16(w, pts + i * 2 * W);
    uint32_t any = 0;
#pragma unroll
    for (int j = 0; j < 2 * W; ++j) any |= w[j];
    live = any != 0;
    Aff<F> q;
    load(q.x, w);
    load(q.y, w + W);
    mont_in(q.x);
    mont_in(q.y);
    store(w, q.x);
    store(w + W, q.y);
    st16(pts_mont + i * 2 * W, w);
    inf[i] = !live;
    ld16(dg.s, scalars + i * 8);
  }
  const uint32_t nb = 1u << (c - 1);
  const int lane = threadIdx.x & 31;
  for (int win = 0; win < nwin; ++win) {
    bool neg;
    const uint32_t mag = dg.next(c, neg);
    const uint32_t key = live && mag ? win * nb + mag - 1 : NO_KEY;
    const uint32_t peers = __match_any_sync(0xffffffffu, key);
    if (key != NO_KEY && lane == __ffs(peers) - 1)
      atomicAdd(counts + key, __popc(peers));
  }
}

// Window w = blockIdx.y's digit again: each nonzero one takes the next
// place of its bucket (cursor, the buckets' offsets), and the point's
// index goes there with the digit's sign in the top bit. The grid runs a
// window at a time (blockIdx.x first), so that the places being written,
// one window's share of `sorted`, stay in L2 while their sectors fill.
__global__ void __launch_bounds__(THREADS)
    msm_scatter_kernel(const uint32_t* __restrict__ scalars,
                       const uint8_t* __restrict__ inf, int64_t n, int c,
                       uint32_t* __restrict__ cursor,
                       uint32_t* __restrict__ sorted) {
  const int64_t i = thread_id();
  const bool live = i < n && !inf[i];
  SignedDigits dg;
#pragma unroll
  for (int j = 0; j < 8; ++j) dg.s[j] = 0;
  if (live) ld16(dg.s, scalars + i * 8);
  const uint32_t nb = 1u << (c - 1);
  const int lane = threadIdx.x & 31;
  const int win = blockIdx.y;
  bool neg;
  for (int w = 0; w < win; ++w) dg.next(c, neg);   // the carry into win
  const uint32_t mag = dg.next(c, neg);
  const uint32_t key = live && mag ? win * nb + mag - 1 : NO_KEY;
  const uint32_t peers = __match_any_sync(0xffffffffu, key);
  const int leader = __ffs(peers) - 1;
  uint32_t base = 0;
  if (key != NO_KEY && lane == leader)
    base = atomicAdd(cursor + key, __popc(peers));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (key != NO_KEY)
    sorted[base + __popc(peers & ((1u << lane) - 1))] =
        static_cast<uint32_t>(i) | (neg ? NEG : 0u);
}

// exclusive scan of one value a thread over a block of SCAN_THREADS;
// *total gets the block's sum
__device__ __forceinline__ uint32_t block_scan(uint32_t v, uint32_t* total) {
  __shared__ uint32_t warp_sum[SCAN_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t s = warp_sum[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    warp_sum[lane] = s;
  }
  __syncthreads();
  const uint32_t before = warp ? warp_sum[warp - 1] : 0;
  *total = warp_sum[SCAN_THREADS / 32 - 1];
  __syncthreads();
  return before + x - v;
}

// the histogram's sum per tile of SCAN_TILE buckets
__global__ void __launch_bounds__(SCAN_THREADS)
    msm_scan_reduce_kernel(const uint32_t* __restrict__ counts, int64_t nb_all,
                           uint32_t* __restrict__ tile_sums) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * SCAN_TILE +
                        threadIdx.x * SCAN_ITEMS;
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j)
    if (first + j < nb_all) v += counts[first + j];
  uint32_t total;
  block_scan(v, &total);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// the tiles' sums scanned in place (one block); the grand total, the
// entries in all, into offsets[nb_all]
__global__ void __launch_bounds__(SCAN_THREADS)
    msm_scan_tiles_kernel(uint32_t* __restrict__ tile_sums, int tiles,
                          uint32_t* __restrict__ grand_total) {
  uint32_t carry = 0;
  for (int base = 0; base < tiles; base += SCAN_THREADS) {
    const int k = base + threadIdx.x;
    const uint32_t v = k < tiles ? tile_sums[k] : 0;
    uint32_t total;
    const uint32_t x = block_scan(v, &total);
    if (k < tiles) tile_sums[k] = carry + x;
    carry += total;
  }
  if (threadIdx.x == 0) *grand_total = carry;
}

// each bucket's first place: offsets and the scatter's cursor
__global__ void __launch_bounds__(SCAN_THREADS)
    msm_scan_apply_kernel(const uint32_t* __restrict__ counts, int64_t nb_all,
                          const uint32_t* __restrict__ tile_off,
                          uint32_t* __restrict__ offsets,
                          uint32_t* __restrict__ cursor) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * SCAN_TILE +
                        threadIdx.x * SCAN_ITEMS;
  uint32_t v[SCAN_ITEMS], sum = 0;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    v[j] = first + j < nb_all ? counts[first + j] : 0;
    sum += v[j];
  }
  uint32_t total;
  uint32_t at = tile_off[blockIdx.x] + block_scan(sum, &total);
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    if (first + j < nb_all) {
      offsets[first + j] = at;
      cursor[first + j] = at;
    }
    at += v[j];
  }
}

// the bucket k holding sorted place j: offsets[k] <= j < offsets[k + 1],
// searched in [lo, hi) with offsets[lo] <= j < offsets[hi]
__device__ __forceinline__ int64_t bucket_of(const uint32_t* offsets,
                                             int64_t lo, int64_t hi,
                                             uint32_t j) {
  while (hi - lo > 1) {
    const int64_t mid = (lo + hi) >> 1;
    if (offsets[mid] <= j)
      lo = mid;
    else
      hi = mid;
  }
  return lo;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the point of a sorted entry into this thread's slot of the ring
template <int V>
__device__ __forceinline__ void fetch_point(uint4 (*slot)[MSM_THREADS],
                                            int tid,
                                            const uint32_t* pts_mont,
                                            uint32_t entry) {
  const uint4* src = reinterpret_cast<const uint4*>(
      pts_mont + static_cast<int64_t>(entry & ~NEG) * V * 4);
#pragma unroll
  for (int v = 0; v < V; ++v) cp_async16(&slot[v][tid], src + v);
  cp_async_commit();
}

// Chunk t: the sorted places [t L, t L + L), one thread each, every chunk
// equally long whatever the buckets, so that a bucket that holds a large
// share of the points (a skewed scalar set) spreads over many threads. The
// thread adds its chunk's points (negated for a negative digit) into an
// XYZZ sum, one mixed addition each, the next point on its way into a
// two-slot ring in shared memory (cp.async) while the last one is added;
// where a bucket ends, its sum goes to bucket_sum (a bucket wholly in the
// chunk) or to head[t] (a bucket begun in an earlier chunk); a bucket that
// runs on past the chunk leaves its sum in tail[t], its key in
// tail_key[t] (else -1), for msm_tree_kernel.
template <class F>
__global__ void __launch_bounds__(MSM_THREADS)
    msm_bucket_kernel(const uint32_t* __restrict__ pts_mont,
                      const uint32_t* __restrict__ sorted,
                      const uint32_t* __restrict__ offsets, int64_t nb_all,
                      int L, int64_t nchunks, uint32_t* __restrict__ bucket_sum,
                      uint32_t* __restrict__ head, uint32_t* __restrict__ tail,
                      int32_t* __restrict__ tail_key) {
  constexpr int W = words<F>();
  constexpr int V = 2 * W / 4;               // 16-byte pieces of a point
  __shared__ uint4 ring[2][V][MSM_THREADS];  // [slot][piece][thread]
  const int64_t t = thread_id();
  if (t >= nchunks) return;
  const uint32_t total = offsets[nb_all];
  const uint32_t begin = static_cast<uint32_t>(t * L);
  if (begin >= total) return;
  const uint32_t end = min(begin + static_cast<uint32_t>(L), total);
  int64_t k = bucket_of(offsets, 0, nb_all, begin);
  uint32_t bucket_end = offsets[k + 1];
  bool began_before = offsets[k] < begin;
  const int tid = threadIdx.x;

  uint32_t entry = sorted[begin];
  fetch_point<V>(ring[0], tid, pts_mont, entry);
  uint32_t next = begin + 1 < end ? sorted[begin + 1] : 0;
  Xyzz<F> acc;
  xyzz_set_inf(acc);
  int32_t key = -1;
#pragma unroll 1
  for (uint32_t j = begin; j < end; ++j) {
    const int slot = (j - begin) & 1;
    const bool neg = entry & NEG;
    if (j + 1 < end) {
      fetch_point<V>(ring[slot ^ 1], tid, pts_mont, next);
      entry = next;
      next = j + 2 < end ? sorted[j + 2] : 0;
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    uint32_t w[2 * W];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const uint4 u = ring[slot][v][tid];
      w[4 * v] = u.x;
      w[4 * v + 1] = u.y;
      w[4 * v + 2] = u.z;
      w[4 * v + 3] = u.w;
    }
    Aff<F> q;
    load(q.x, w);
    load(q.y, w + W);
    if (neg) fneg(q.y, q.y);
    xyzz_add_mixed(acc, q);
    if (j + 1 == bucket_end) {
      store_xyzz((began_before ? head + t * 4 * W : bucket_sum + k * 4 * W),
                 acc);
      if (j + 1 < end) {
        k = bucket_of(offsets, k + 1, nb_all, j + 1);
        bucket_end = offsets[k + 1];
        began_before = false;
        xyzz_set_inf(acc);
      }
    } else if (j + 1 == end) {
      store_xyzz(tail + t * 4 * W, acc);
      key = static_cast<int32_t>(k);
    }
  }
  tail_key[t] = key;
}

// One pass of the sums of the buckets that span chunks: a bucket's tails
// lie in chunks t0 .. t1 - 1 (t1 the chunk of its last place, whose head
// holds the rest). In pass s (step 8^s) chunk t0 + 8 step q adds the tails
// of the seven chunks step, 2 step, .. 7 step after it; once a pass has
// folded all of a bucket's m = t1 - t0 tails into tail[t0] (m <= 8 step),
// chunk t0 adds head[t1] and writes the bucket's sum. A bucket of every
// point spans at most n / L + 1 chunks, so `passes` = log8 of that always
// ends every bucket; with random scalars the first pass does, and a pass
// whose flag (*more, set by the pass before) is clear returns at once.
template <class F>
__global__ void __launch_bounds__(MSM_THREADS)
    msm_tree_kernel(const uint32_t* __restrict__ offsets, int64_t nb_all,
                    int L, int64_t nchunks, int64_t step,
                    uint32_t* __restrict__ tail,
                    const int32_t* __restrict__ tail_key,
                    const uint32_t* __restrict__ head,
                    uint32_t* __restrict__ bucket_sum,
                    int32_t* __restrict__ more) {
  constexpr int W = words<F>();
  const int64_t t = thread_id();
  if (!*more || t >= nchunks || t * L >= offsets[nb_all]) return;
  const int32_t k = tail_key[t];
  if (k < 0) return;
  const int64_t t0 = offsets[k] / L;
  const int64_t t1 = (offsets[k + 1] - 1) / L;
  const int64_t jj = t - t0, m = t1 - t0;
  if (jj % (8 * step) || (step > 1 && m <= step)) return;
  auto* acc = reinterpret_cast<Xyzz<F>*>(tail + t * 4 * W);
#pragma unroll 1
  for (int i = 1; i < 8 && jj + i * step < m; ++i)
    xyzz_acc(acc, reinterpret_cast<const Xyzz<F>*>(
                      tail + (t + i * step) * 4 * W));
  if (jj == 0 && m <= 8 * step) {
    xyzz_acc(acc, reinterpret_cast<const Xyzz<F>*>(head + t1 * 4 * W));
    *reinterpret_cast<Xyzz<F>*>(bucket_sum + static_cast<int64_t>(k) * 4 * W) =
        *acc;
  } else if (jj == 0) {
    more[1] = 1;   // the next pass has work
  }
}

constexpr int REDUCE_MAX = 64;  // threads of a reduce block, at most

// Window w = blockIdx.y, its buckets |d| = 1 .. 2^(c-1) cut into runs of
// Ls, one thread each over the whole grid. Thread i of block j holds run
// s = j T + i (T = blockDim.x, lo_s = s Ls + 1) and forms, from the top
// bucket down, its running sum R_s = sum B_d and A_s = sum (d - lo_s + 1)
// B_d, so that the window's sum_d d B_d is
//   sum_s A_s + Ls sum_s s R_s
//   = sum_j A_j + Ls sum_j (W_j + T j S_j),
// with A_j = sum_i A_s, S_j = sum_i R_s and W_j = sum_i i R_s per block.
// The block writes those three points to partials[(w bw + j) 3 + 0..2]:
// A_j and S_j by trees in shared memory, W_j as the sum of the suffix
// sums of R over i >= 1 (a Hillis-Steele scan). Every addition goes
// through xyzz_acc on shared or device memory; an empty bucket
// (offsets[k] == offsets[k + 1]) is never read.
template <class F>
__global__ void __launch_bounds__(REDUCE_MAX)
    msm_reduce_kernel(const uint32_t* __restrict__ offsets,
                      const uint32_t* __restrict__ bucket_sum, int c, int Ls,
                      uint32_t* __restrict__ partials) {
  constexpr int W = words<F>();
  __shared__ Xyzz<F> sa[REDUCE_MAX], sr[REDUCE_MAX];
  const int s = threadIdx.x, T = blockDim.x;
  const int64_t nb = int64_t{1} << (c - 1);
  const int64_t base = blockIdx.y * nb;
  const int64_t lo = (static_cast<int64_t>(blockIdx.x) * T + s) * Ls + 1;
  const auto* buckets = reinterpret_cast<const Xyzz<F>*>(bucket_sum);
  xyzz_set_inf(sa[s]);
  xyzz_set_inf(sr[s]);
#pragma unroll 1
  for (int64_t k = base + lo + Ls - 2; k >= base + lo - 1; --k) {
    if (offsets[k + 1] > offsets[k]) xyzz_acc(&sr[s], buckets + k);
    xyzz_acc(&sa[s], &sr[s]);
  }
  __syncthreads();
  auto* out = reinterpret_cast<Xyzz<F>*>(partials) +
              (static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x) * 3;
  for (int half = T / 2; half > 0; half >>= 1) {
    if (s < half) xyzz_acc(&sa[s], &sa[s + half]);
    __syncthreads();
  }
  if (s == 0) out[0] = sa[0];
  __syncthreads();
  // suffix sums of R, ping-ponged between sr and sa
  Xyzz<F>* src = sr;
  Xyzz<F>* dst = sa;
  for (int d = 1; d < T; d <<= 1) {
    dst[s] = src[s];
    if (s + d < T) xyzz_acc(&dst[s], &src[s + d]);
    __syncthreads();
    Xyzz<F>* x = src;
    src = dst;
    dst = x;
  }
  if (s == 0) {
    out[2] = src[0];
    xyzz_set_inf(src[0]);
  }
  __syncthreads();
  for (int half = T / 2; half > 0; half >>= 1) {
    if (s < half) xyzz_acc(&src[s], &src[s + half]);
    __syncthreads();
  }
  if (s == 0) out[1] = src[0];
}

// window w = blockIdx.x over its bw = blockDim.x blocks' partials: X =
// sum_j A_j, Y = sum_j W_j, Z = sum_j j S_j (suffix sums of S, then their
// sum over j >= 1), each by a tree in shared memory; then the window's
// sum_d d B_d = X + 2^a Y + 2^b Z (a = log2 Ls, b = log2 Ls T) by b
// doublings, in Jacobian coordinates into windows[w]
template <class F>
__global__ void __launch_bounds__(REDUCE_MAX)
    msm_window_kernel(const uint32_t* __restrict__ partials, int a, int b,
                      uint32_t* __restrict__ windows) {
  constexpr int W = words<F>();
  __shared__ Xyzz<F> sa[REDUCE_MAX], sb[REDUCE_MAX];
  __shared__ Xyzz<F> xy[2];
  const int s = threadIdx.x, T = blockDim.x;
  const auto* in = reinterpret_cast<const Xyzz<F>*>(partials) +
                   static_cast<int64_t>(blockIdx.x) * T * 3;
  // X in sa and Y in sb side by side: the first half of the block's
  // lanes (rounded up to a warp) sums X, the second Y
  sa[s] = in[s * 3];
  sb[s] = in[s * 3 + 1];
  __syncthreads();
  const int hw = T > 32 ? T / 2 : 32;  // Y's lanes start here
  for (int half = T / 2; half > 0; half >>= 1) {
    if (s < half) xyzz_acc(&sa[s], &sa[s + half]);
    if (s >= hw && s - hw < half) xyzz_acc(&sb[s - hw], &sb[s - hw + half]);
    if (T <= 32 && s < half) xyzz_acc(&sb[s], &sb[s + half]);
    __syncthreads();
  }
  if (s == 0) {
    xy[0] = sa[0];
    xy[1] = sb[0];
  }
  __syncthreads();
  sa[s] = in[s * 3 + 2];
  __syncthreads();
  Xyzz<F>* src = sa;
  Xyzz<F>* dst = sb;
  for (int d = 1; d < T; d <<= 1) {
    dst[s] = src[s];
    if (s + d < T) xyzz_acc(&dst[s], &src[s + d]);
    __syncthreads();
    Xyzz<F>* x = src;
    src = dst;
    dst = x;
  }
  if (s == 0) xyzz_set_inf(src[0]);
  __syncthreads();
  for (int half = T / 2; half > 0; half >>= 1) {
    if (s < half) xyzz_acc(&src[s], &src[s + half]);
    __syncthreads();
  }
  if (s == 0) {
    Xyzz<F>* v = &src[0];   // Z
    for (int i = a; i < b; ++i) xyzz_dbl(v);
    xyzz_acc(v, &xy[1]);
    for (int i = 0; i < a; ++i) xyzz_dbl(v);
    xyzz_acc(v, &xy[0]);
    Jac<F> r;
    xyzz_to_jac(r, *v);
    uint32_t* out = windows + static_cast<int64_t>(blockIdx.x) * 3 * W;
    store(out, r.X);
    store(out + W, r.Y);
    store(out + 2 * W, r.Z);
  }
}

// sum_w 2^(c w) window_w, high to low in Jacobian coordinates (a
// doubling is 7 products there, 9 in XYZZ): one warp, every lane holding
// the sum, its doublings' independent products spread over the lanes
// (jac_double_lat); a serial chain of about 254 doublings (skipped while
// the sum is still infinity), then affine, ordinary form, from lane 0
template <class F>
__global__ void __launch_bounds__(32)
    msm_horner_kernel(const uint32_t* __restrict__ windows, int c, int nwin,
                      uint32_t* __restrict__ out) {
  constexpr int W = words<F>();
  Jac<F> acc, q;
  jac_set_inf(acc);
#pragma unroll 1
  for (int w = nwin - 1; w >= 0; --w) {
#pragma unroll 1
    for (int e = 0; e < c && !fis_zero(acc.Z); ++e) jac_double_lat(acc);
    const uint32_t* src = windows + static_cast<int64_t>(w) * 3 * W;
    load(q.X, src);
    load(q.Y, src + W);
    load(q.Z, src + 2 * W);
    jac_add(acc, acc, q);
  }
  if (threadIdx.x == 0) store_affine(out, acc);
}

// ---------------------------------------------------------------------------
// Fixed-base products k * G
// ---------------------------------------------------------------------------

// A block of G1 threads, or of G2 threads (whose Fp2 group law holds about
// twice the registers): each thread one scalar, or one run of table entries
template <class F>
__host__ __device__ constexpr int fb_threads() {
  return words<F>() == 8 ? 256 : 128;
}

// fixed_base_kernel's blocks an SM: G1 two at its 98 registers; G2 three
// (168 registers: 5 % faster than two at 181, `msm_bench --parent`)
template <class F>
__host__ __device__ constexpr int fb_blocks() {
  return words<F>() == 8 ? 1 : 3;
}

// The affine points of the block's XYZZ points, one a thread, with one
// inversion for the whole block (Montgomery's trick as a product tree in
// shared memory, `tree` 2 blockDim.x elements): the leaves are the ZZZ
// (1 for a thread past the end or at infinity), the inner nodes their
// products (blockDim.x - 1), the root inverted by finv in one thread,
// the inverses pushed down (2 products a node); then 1/ZZ = ZZ^2 / ZZZ^2,
// x = X / ZZ, y = Y / ZZZ. Montgomery form in and out, zeros for
// infinity. Every thread of the block must call it (blockDim.x a power of
// two).
template <class F>
__device__ __forceinline__ void block_affine(const Xyzz<F>& p, bool live,
                                             F* tree, Aff<F>& out) {
  const int T = blockDim.x, t = threadIdx.x;
  const bool inf = !live || fis_zero(p.ZZ);
  if (inf)
    fset_one(tree[T + t]);
  else
    tree[T + t] = p.ZZZ;
  __syncthreads();
  for (int half = T / 2; half >= 1; half >>= 1) {
    if (t < half) {
      const int k = half + t;
      fmul(tree[k], tree[2 * k], tree[2 * k + 1]);
    }
    __syncthreads();
  }
  if (t == 0) finv(tree[1], tree[1]);
  __syncthreads();
  for (int half = 1; half < T; half <<= 1) {
    if (t < half) {
      const int k = half + t;
      const F inv = tree[k], a = tree[2 * k], b = tree[2 * k + 1];
      fmul(tree[2 * k], inv, b);
      fmul(tree[2 * k + 1], inv, a);
    }
    __syncthreads();
  }
  if (inf) {
    fset_zero(out.x);
    fset_zero(out.y);
    return;
  }
  const F w = tree[T + t];   // 1 / ZZZ
  F zi, w2;
  fsq(w2, w);
  fsq(zi, p.ZZ);
  fmul(zi, zi, w2);          // 1 / ZZ
  fmul(out.x, p.X, zi);
  fmul(out.y, p.Y, w);
}

// s below 2^254 (the signed digits' range): r subtracted while s >= 2^254,
// at most four times below 2^256, so that s * G is unchanged
__device__ __forceinline__ void reduce_scalar(uint32_t (&s)[8]) {
#pragma unroll 1
  while (s[7] >> 30) {
    uint32_t d[8];
    sub_p<Fr>(d, s);
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = d[j];
  }
}

// The table build, before its normalisation: thread (window j, run q) of
// the entries d = q FB_RUN + 1 .. q FB_RUN + FB_RUN (at most 2^(c-1)) of
// window j: d B_j by double-and-add from bases[j] = B_j = 2^(c j) G
// (affine, Montgomery), then B_j added once an entry, each entry's XYZZ
// point into xyzz[j 2^(c-1) + d - 1]
template <class F>
__global__ void __launch_bounds__(fb_threads<F>())
    fb_table_kernel(const uint32_t* __restrict__ bases, int c, int nwin,
                    uint32_t* __restrict__ xyzz) {
  constexpr int W = words<F>();
  const int64_t nb = int64_t{1} << (c - 1);
  const int64_t runs = (nb + FB_RUN - 1) / FB_RUN;
  const int64_t t = thread_id();
  if (t >= runs * nwin) return;
  const int64_t j = t / runs;
  const int64_t d0 = (t % runs) * FB_RUN + 1;
  Aff<F> b;
  load(b.x, bases + j * 2 * W);
  load(b.y, bases + j * 2 * W + W);
  Xyzz<F> acc;
  xyzz_set_inf(acc);
  const int cnt = static_cast<int>(
      min(static_cast<int64_t>(FB_RUN), nb - d0 + 1));
  uint32_t* dst = xyzz + (j * nb + d0 - 1) * 4 * W;
  // the doublings and additions of d0 B from its top bit, then one
  // addition an entry: one inlined addition for both
  int bit = 63 - __clzll(d0), k = 0;
#pragma unroll 1
  while (true) {
    if (bit >= 0) xyzz_double_inl(acc, acc);
    if (bit < 0 || ((d0 >> bit) & 1)) xyzz_add_mixed(acc, b);
    if (bit <= 0) {
      store_xyzz(dst + k * 4 * W, acc);
      if (++k == cnt) break;
    }
    --bit;
  }
}

// count XYZZ points to affine Montgomery form, a block at a time
template <class F>
__global__ void __launch_bounds__(fb_threads<F>())
    fb_normalize_kernel(const uint32_t* __restrict__ xyzz, int64_t count,
                        uint32_t* __restrict__ out) {
  constexpr int W = words<F>();
  __shared__ F tree[2 * fb_threads<F>()];
  const int64_t i = thread_id();
  const bool live = i < count;
  Xyzz<F> p;
  xyzz_set_inf(p);
  if (live) {
    uint32_t w[4 * W];
    ld16(w, xyzz + i * 4 * W);
    load(p.X, w);
    load(p.Y, w + W);
    load(p.ZZ, w + 2 * W);
    load(p.ZZZ, w + 3 * W);
  }
  Aff<F> a;
  block_affine(p, live, tree, a);
  if (live) {
    uint32_t w[2 * W];
    store(w, a.x);
    store(w + W, a.y);
    st16(out + i * 2 * W, w);
  }
}

// k_i * G, one scalar a thread: its signed c-bit digits (SignedDigits,
// recoded once as the windows pass), one mixed XYZZ addition of the table
// entry |d| 2^(c j) G (its y negated for a negative digit) per nonzero
// digit, the first one a copy; then the block's points to affine with one
// inversion (block_affine) and out in ordinary form
template <class F>
__global__ void __launch_bounds__(fb_threads<F>(), fb_blocks<F>())
    fixed_base_kernel(const uint32_t* __restrict__ table,
                      const uint32_t* __restrict__ scalars, int64_t n, int c,
                      int nwin, uint32_t* __restrict__ out) {
  constexpr int W = words<F>();
  __shared__ F tree[2 * fb_threads<F>()];
  const int64_t i = thread_id();
  const bool live = i < n;
  Xyzz<F> acc;
  xyzz_set_inf(acc);
  if (live) {
    SignedDigits dg;
    ld16(dg.s, scalars + i * 8);
    reduce_scalar(dg.s);
    const int64_t nb = int64_t{1} << (c - 1);
#pragma unroll 1
    for (int j = 0; j < nwin; ++j) {
      bool neg;
      const uint32_t mag = dg.next(c, neg);
      if (mag) {
        uint32_t w[2 * W];
        ld16(w, table + (j * nb + mag - 1) * 2 * W);
        Aff<F> q;
        load(q.x, w);
        load(q.y, w + W);
        if (neg) fneg(q.y, q.y);
        xyzz_add_mixed(acc, q);
      }
    }
  }
  Aff<F> a;
  block_affine(acc, live, tree, a);
  if (live) {
    mont_out(a.x);
    mont_out(a.y);
    uint32_t w[2 * W];
    store(w, a.x);
    store(w + W, a.y);
    st16(out + i * 2 * W, w);
  }
}

#if !BN254_G2

// ---------------------------------------------------------------------------
// Fr NTT
// ---------------------------------------------------------------------------

__device__ __forceinline__ FrE fr_of(const U8& u) {
  FrE r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = u.v[j];
  return r;
}

// an element from 16-byte aligned shared or device memory, and back
__device__ __forceinline__ void ld_fr(FrE& a, const uint32_t* p) {
  ld16(a.v, p);
}
__device__ __forceinline__ void st_fr(uint32_t* p, const FrE& a) {
  st16(p, a.v);
}

// base^e (Montgomery) for a small exponent
__device__ __forceinline__ void fr_pow_small(FrE& r, const FrE& base,
                                             uint64_t e) {
  FrE acc, b = base;
  fset_one(acc);
  while (e) {
    if (e & 1) fmul(acc, acc, b);
    e >>= 1;
    if (e) fsq(b, b);
  }
  r = acc;
}

// out[j] = scale * base^j (Montgomery) for j < count: a cached table
__global__ void __launch_bounds__(THREADS)
    fr_powers_kernel(uint32_t* __restrict__ out, int64_t count, U8 base,
                     U8 scale) {
  const int64_t j = thread_id();
  if (j >= count) return;
  FrE r;
  fr_pow_small(r, fr_of(base), static_cast<uint64_t>(j));
  fmul(r, fr_of(scale), r);
  store(out + j * 8, r);
}

// x below r from any x below 2^256 (at most five subtractions)
__device__ __forceinline__ void reduce_full(FrE& x) {
#pragma unroll 1
  for (int k = 0; k < 5; ++k) {
    uint32_t d[8];
    if (sub_p<Fr>(d, x.v)) break;
#pragma unroll
    for (int j = 0; j < 8; ++j) x.v[j] = d[j];
  }
}

constexpr int NTT_THREADS = 256;
constexpr int NTT_TILE = 1 << NTT_TILE_LOG;
constexpr int NTT_SMEM = (NTT_TILE + NTT_TILE / 2) * 32;  // tile + twiddles

// one pass of the plan (ops/bn254_device.py ntt_plan): `tiles`
// sub-transforms of 2^lm points; tile t = t_hi t_lo' + t_lo reads the
// elements t_hi a1 + t_lo a2 + j in_stride and writes output k to
// t_hi b1 + t_lo b2 + k out_stride, times w_n^(t_lo k twist) when
// twist > 0 (the four-step twist between passes)
struct NttPass {
  long long lm, tiles, t_lo, a1, a2, in_stride, b1, b2, out_stride, twist;
};

// base^e = hi[e >> h] * lo[e & (2^h - 1)]: two cached tables of about
// sqrt(n) Montgomery powers; lo = nullptr for none
struct Pow2 {
  const uint32_t* lo;
  const uint32_t* hi;
  int h;
};

__device__ __forceinline__ void pow_factor(FrE& r, const Pow2& t, int64_t e) {
  FrE a, b;
  ld_fr(a, t.hi + (e >> t.h) * 8);
  ld_fr(b, t.lo + (e & ((int64_t{1} << t.h) - 1)) * 8);
  fmul(r, a, b);
}

// The elements stay in ordinary form throughout: a product by a Montgomery
// factor (w R, g^i R) is the ordinary product. The first pass multiplies
// each input by shift^i (in_pow) or reduces it below r; the last pass each
// output by scale post^k (out_pow) or by scale (has_scale, the inverse's
// 1/n). A block loads the twiddles w_(2^TL)^l (l < 2^(TL-1), Montgomery)
// into shared memory once, then walks its tiles: each element to its
// bit-reversed place in the tile (16-byte loads), the lm radix-2 DIT
// stages in shared memory, two at a time (stage s's twiddle w_(2^s)^l =
// w_(2^TL)^(l 2^(TL - s)); stage 1's is 1), the twist, the outputs. Two
// stages at a time took the forward transform at 2^21 from 0.915 to
// 0.871 ms of device time (`msm_bench --parent`, NVIDIA H100). src and
// dst may be
// one buffer (a middle pass): a tile reads all of its elements before it
// writes any, and no two tiles share one.
__global__ void __launch_bounds__(NTT_THREADS, 2)
    fr_ntt_pass_kernel(const uint32_t* src, uint32_t* dst,
                       const uint32_t* __restrict__ twiddles, NttPass p,
                       Pow2 twist, Pow2 in_pow, Pow2 out_pow, U8 scale,
                       int first, int last, int has_scale) {
  extern __shared__ uint4 smem4[];
  uint32_t* tile = reinterpret_cast<uint32_t*>(smem4);
  uint32_t* wsh = tile + NTT_TILE * 8;
  for (int k = threadIdx.x; k < NTT_TILE / 2; k += blockDim.x) {
    FrE w;
    ld_fr(w, twiddles + k * 8);
    st_fr(wsh + k * 8, w);
  }
  const int lm = static_cast<int>(p.lm);
  const int m = 1 << lm;
  for (int64_t t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const int64_t th = t / p.t_lo, tl = t % p.t_lo;
    const int64_t ib = th * p.a1 + tl * p.a2, ob = th * p.b1 + tl * p.b2;
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
      const int64_t gi = ib + j * p.in_stride;
      FrE x;
      ld_fr(x, src + gi * 8);
      if (first && in_pow.lo) {
        FrE f;
        pow_factor(f, in_pow, gi);
        fmul(x, x, f);
      } else if (first) {
        reduce_full(x);
      }
      const int r = lm ? static_cast<int>(__brev(j) >> (32 - lm)) : 0;
      st_fr(tile + r * 8, x);
    }
    __syncthreads();
    // stages s and s + 1 at once in registers (a radix-4 step: four
    // elements, the same four products as two radix-2 stages, half the
    // shared-memory traffic and barriers), then a last radix-2 stage when
    // lm is odd
    int s = 1;
    for (; s < lm; s += 2) {
      const int h = 1 << (s - 1);
      for (int q = threadIdx.x; q < m / 4; q += blockDim.x) {
        const int l = q & (h - 1);
        const int i = ((q >> (s - 1)) << (s + 1)) + l;
        FrE a0, a1, a2, a3, w;
        ld_fr(a0, tile + i * 8);
        ld_fr(a1, tile + (i + h) * 8);
        ld_fr(a2, tile + (i + 2 * h) * 8);
        ld_fr(a3, tile + (i + 3 * h) * 8);
        if (s > 1) {
          ld_fr(w, wsh + (l << (NTT_TILE_LOG - s)) * 8);
          fmul(a1, a1, w);
          fmul(a3, a3, w);
        }
        FrE b0, b2;
        fadd(b0, a0, a1);
        fsub(a1, a0, a1);     // b1
        fadd(b2, a2, a3);
        fsub(a3, a2, a3);     // b3
        if (s > 1) {   // at s = 1, l = 0 and this twiddle is 1
          ld_fr(w, wsh + (l << (NTT_TILE_LOG - s - 1)) * 8);
          fmul(b2, b2, w);
        }
        ld_fr(w, wsh + ((l + h) << (NTT_TILE_LOG - s - 1)) * 8);
        fmul(a3, a3, w);
        fadd(a0, b0, b2);
        fsub(a2, b0, b2);
        fadd(b0, a1, a3);
        fsub(a3, a1, a3);
        st_fr(tile + i * 8, a0);
        st_fr(tile + (i + h) * 8, b0);
        st_fr(tile + (i + 2 * h) * 8, a2);
        st_fr(tile + (i + 3 * h) * 8, a3);
      }
      __syncthreads();
    }
    if (s == lm) {
      const int h = 1 << (s - 1);
      for (int b = threadIdx.x; b < m / 2; b += blockDim.x) {
        const int l = b & (h - 1);
        const int i = ((b >> (s - 1)) << s) + l;
        FrE u, v, sum;
        ld_fr(u, tile + i * 8);
        ld_fr(v, tile + (i + h) * 8);
        if (s > 1) {
          FrE w;
          ld_fr(w, wsh + (l << (NTT_TILE_LOG - s)) * 8);
          fmul(v, v, w);
        }
        fadd(sum, u, v);
        fsub(v, u, v);
        st_fr(tile + i * 8, sum);
        st_fr(tile + (i + h) * 8, v);
      }
      __syncthreads();
    }
    for (int k = threadIdx.x; k < m; k += blockDim.x) {
      FrE y, f;
      ld_fr(y, tile + k * 8);
      if (p.twist) {
        pow_factor(f, twist, tl * k * p.twist);
        fmul(y, y, f);
      }
      const int64_t go = ob + k * p.out_stride;
      if (last && out_pow.lo) {
        pow_factor(f, out_pow, go);
        fmul(y, y, f);
      } else if (last && has_scale) {
        fmul(y, y, fr_of(scale));
      }
      st_fr(dst + go * 8, y);
    }
    __syncthreads();
  }
}

// (a * b - c) * z in ordinary form: mont(a, b) = ab/R, mont(c, 1) = c/R,
// and mont(., z R^2) = . * z R
__global__ void __launch_bounds__(THREADS)
    fr_pointwise_kernel(const uint32_t* __restrict__ a,
                        const uint32_t* __restrict__ b,
                        const uint32_t* __restrict__ c, U8 z_r2,
                        uint32_t* __restrict__ out, int64_t n) {
  const int64_t i = thread_id();
  if (i >= n) return;
  FrE x, y, t, one;
  load(x, a + i * 8);
  load(y, b + i * 8);
  fmul(t, x, y);
  load(x, c + i * 8);
  fset_zero(one);
  one.v[0] = 1;
  fmul(x, x, one);
  fsub(t, t, x);
  fmul(t, t, fr_of(z_r2));
  store(out + i * 8, t);
}

#endif  // !BN254_G2

U8 u8_of(const void* p) {
  U8 u;
  const uint32_t* w = static_cast<const uint32_t*>(p);
  for (int j = 0; j < 8; ++j) u.v[j] = w[j];
  return u;
}

int status() { return static_cast<int>(cudaGetLastError()); }

// the largest grid of `kernel` that is resident at once, at most `want`
template <class K>
int resident_grid(K kernel, int threads, int smem, int64_t want) {
  int per_sm = 0, sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  const int64_t most = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  return static_cast<int>(want < most ? want : most);
}

}  // namespace

#if BN254_G2
using G = G2F;
#else
using G = G1F;
#endif

extern "C" {

// FB_RUN, the fixed-base block (fb_threads), NTT_TILE_LOG, the library's
// group (1 or 2), REDUCE_MAX and NTT_PLAN: what the wrapper plans for and
// checks
int bn254_params(int* out) {
  out[0] = FB_RUN;
  out[1] = fb_threads<G>();
  out[2] = NTT_TILE_LOG;
  out[3] = BN254_G2 ? 2 : 1;
  out[4] = REDUCE_MAX;
  out[5] = NTT_PLAN;
  return 0;
}

// The MSM's first half: the points to Montgomery form and the histogram
// of their signed digits (msm_count_kernel), its exclusive scan into the
// buckets' offsets (offsets[nwin << (c - 1)] is the number of entries),
// then the points' indices scattered into bucket order (sorted). Every
// buffer is the wrapper's; `counts` is cleared here.
int bn254_msm_sort(const void* pts, const void* scalars, long long n, int c,
                   int nwin, void* pts_mont, void* inf, void* counts,
                   void* tile_sums, void* offsets, void* cursor, void* sorted,
                   void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t nb_all = static_cast<int64_t>(nwin) << (c - 1);
  const int tiles = static_cast<int>((nb_all + SCAN_TILE - 1) / SCAN_TILE);
  auto cnt = static_cast<uint32_t*>(counts);
  auto ts = static_cast<uint32_t*>(tile_sums);
  auto off = static_cast<uint32_t*>(offsets);
  auto cur = static_cast<uint32_t*>(cursor);
  auto fl = static_cast<uint8_t*>(inf);
  cudaError_t e = cudaMemsetAsync(cnt, 0, nb_all * 4, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  msm_count_kernel<G><<<blocks_for(n), THREADS, 0, st>>>(
      static_cast<const uint32_t*>(pts), static_cast<const uint32_t*>(scalars),
      n, c, nwin, static_cast<uint32_t*>(pts_mont), fl, cnt);
  int err = status();
  if (err) return err;
  msm_scan_reduce_kernel<<<tiles, SCAN_THREADS, 0, st>>>(cnt, nb_all, ts);
  if ((err = status())) return err;
  msm_scan_tiles_kernel<<<1, SCAN_THREADS, 0, st>>>(ts, tiles, off + nb_all);
  if ((err = status())) return err;
  msm_scan_apply_kernel<<<tiles, SCAN_THREADS, 0, st>>>(cnt, nb_all, ts, off,
                                                        cur);
  if ((err = status())) return err;
  msm_scatter_kernel<<<dim3(blocks_for(n), nwin), THREADS, 0, st>>>(
      static_cast<const uint32_t*>(scalars), fl, n, c, cur,
      static_cast<uint32_t*>(sorted));
  return status();
}

// The second half: the chunks' sums (msm_bucket_kernel over `nchunks`
// chunks of L places), `passes` tree passes for the buckets that span
// chunks, the reduction of each window's buckets (bw blocks of tr threads
// a window, runs of Ls buckets a thread; tr, Ls and bw powers of two,
// tr and bw at most REDUCE_MAX), the windows' sums and the Horner pass
// into `out` (the affine sum, ordinary form, zeros for infinity).
int bn254_msm_sum(const void* pts_mont, const void* sorted,
                  const void* offsets, int c, int nwin, int L,
                  long long nchunks, int passes, int Ls, int tr, int bw,
                  void* bucket_sum, void* head, void* tail, void* tail_key,
                  void* more, void* partials, void* windows, void* out,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t nb_all = static_cast<int64_t>(nwin) << (c - 1);
  auto off = static_cast<const uint32_t*>(offsets);
  auto bs = static_cast<uint32_t*>(bucket_sum);
  auto hd = static_cast<uint32_t*>(head);
  auto tl = static_cast<uint32_t*>(tail);
  auto tk = static_cast<int32_t*>(tail_key);
  auto part = static_cast<uint32_t*>(partials);
  auto win = static_cast<uint32_t*>(windows);
  if (nchunks > 0) {
    const int grid = blocks_for(nchunks, MSM_THREADS);
    msm_bucket_kernel<G><<<grid, MSM_THREADS, 0, st>>>(
        static_cast<const uint32_t*>(pts_mont),
        static_cast<const uint32_t*>(sorted), off, nb_all, L, nchunks, bs, hd,
        tl, tk);
    int err = status();
    if (err) return err;
    // more[s]: pass s has work (pass 0 always)
    auto mo = static_cast<int32_t*>(more);
    cudaError_t e = cudaMemsetAsync(mo, 0, (passes + 1) * 4, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaMemsetAsync(mo, 0xff, 4, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    int64_t step = 1;
    for (int s = 0; s < passes; ++s, step *= 8) {
      msm_tree_kernel<G><<<grid, MSM_THREADS, 0, st>>>(
          off, nb_all, L, nchunks, step, tl, tk, hd, bs, mo + s);
      if ((err = status())) return err;
    }
  }
  msm_reduce_kernel<G><<<dim3(bw, nwin), tr, 0, st>>>(off, bs, c, Ls, part);
  int err = status();
  if (err) return err;
  msm_window_kernel<G><<<nwin, bw, 0, st>>>(part, __builtin_ctz(Ls),
                                            __builtin_ctz(Ls * tr), win);
  if ((err = status())) return err;
  msm_horner_kernel<G><<<1, 32, 0, st>>>(win, c, nwin,
                                        static_cast<uint32_t*>(out));
  return status();
}

// The generator's table for signed c-bit digits: entry [j][d - 1] is the
// affine d 2^(c j) G (Montgomery), d = 1 .. 2^(c-1), j < nwin, from the
// nwin bases 2^(c j) G (affine, Montgomery); `xyzz` holds the entries'
// XYZZ points between the build and its normalisation
int bn254_fixed_base_table(const void* bases, int c, int nwin, void* xyzz,
                           void* table, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t nb = int64_t{1} << (c - 1);
  const int64_t runs = (nb + FB_RUN - 1) / FB_RUN;
  constexpr int T = fb_threads<G>();
  fb_table_kernel<G><<<blocks_for(runs * nwin, T), T, 0, st>>>(
      static_cast<const uint32_t*>(bases), c, nwin,
      static_cast<uint32_t*>(xyzz));
  int err = status();
  if (err) return err;
  fb_normalize_kernel<G><<<blocks_for(nb * nwin, T), T, 0, st>>>(
      static_cast<const uint32_t*>(xyzz), nb * nwin,
      static_cast<uint32_t*>(table));
  return status();
}

// k_i * G for n scalars from that table (fixed_base_kernel), affine,
// ordinary form, zeros for infinity
int bn254_fixed_base(const void* table, const void* scalars, long long n,
                     int c, int nwin, void* out, void* stream) {
  if (n <= 0) return 0;
  constexpr int T = fb_threads<G>();
  fixed_base_kernel<G><<<blocks_for(n, T), T, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(table),
      static_cast<const uint32_t*>(scalars), n, c, nwin,
      static_cast<uint32_t*>(out));
  return status();
}

#if !BN254_G2

// out[j] = scale * base^j for j < count (Montgomery in and out)
int bn254_fr_powers(void* out, long long count, const void* base,
                    const void* scale, void* stream) {
  if (count <= 0) return 0;
  fr_powers_kernel<<<blocks_for(count), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), count, u8_of(base), u8_of(scale));
  return status();
}

// The whole transform: the passes of `plan` (NTT_PLAN int64 fields each,
// ops/bn254_device.py ntt_plan), in -> out for one pass, else in -> work
// (-> work) -> out. twiddles: w_(2^NTT_TILE_LOG)^l (or its inverse's);
// (tw_lo, tw_hi, tw_h): w_n's powers for the twists; (in_lo, ...) shift's,
// (out_lo, ...) scale post's, nullptr for none; scale (Montgomery) when
// has_scale and there is no post.
int bn254_fr_ntt(const void* in, void* out, void* work, const void* twiddles,
                 const long long* plan, int passes, const void* tw_lo,
                 const void* tw_hi, int tw_h, const void* in_lo,
                 const void* in_hi, int in_h, const void* out_lo,
                 const void* out_hi, int out_h, const void* scale,
                 int has_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the kernel's shared memory and its resident grid, set once
  static int resident = 0;
  if (!resident) {
    cudaError_t e = cudaFuncSetAttribute(
        fr_ntt_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        NTT_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    resident = resident_grid(fr_ntt_pass_kernel, NTT_THREADS, NTT_SMEM,
                             int64_t{1} << 40);
  }
  const Pow2 tw{static_cast<const uint32_t*>(tw_lo),
                static_cast<const uint32_t*>(tw_hi), tw_h};
  const Pow2 ip{static_cast<const uint32_t*>(in_lo),
                static_cast<const uint32_t*>(in_hi), in_h};
  const Pow2 op{static_cast<const uint32_t*>(out_lo),
                static_cast<const uint32_t*>(out_hi), out_h};
  for (int q = 0; q < passes; ++q) {
    const long long* f = plan + q * NTT_PLAN;
    const NttPass p{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9]};
    const uint32_t* src = static_cast<const uint32_t*>(q ? work : in);
    uint32_t* dst = static_cast<uint32_t*>(q == passes - 1 ? out : work);
    const int grid = static_cast<int>(p.tiles < resident ? p.tiles : resident);
    fr_ntt_pass_kernel<<<grid, NTT_THREADS, NTT_SMEM, st>>>(
        src, dst, static_cast<const uint32_t*>(twiddles), p, tw, ip, op,
        u8_of(scale), q == 0, q == passes - 1, has_scale);
    const int err = status();
    if (err) return err;
  }
  return 0;
}

int bn254_fr_pointwise(const void* a, const void* b, const void* c,
                       const void* z_r2, void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  fr_pointwise_kernel<<<blocks_for(n), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<const uint32_t*>(c), u8_of(z_r2),
      static_cast<uint32_t*>(out), n);
  return status();
}

#endif  // !BN254_G2

}  // extern "C"
