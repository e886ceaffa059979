// The BN254 kernels of the SNARK wrap (sm_90a), one library with a plain C
// interface (ops/bn254_cuda.py binds it with ctypes), on csrc/bn254.cuh.
//
// What each replaces, and what bounds it on this card:
//  - msm_prep_kernel, msm_bucket_kernel, msm_bucket_sum_kernel,
//    msm_reduce_kernel, msm_combine_kernel: the Pippenger MSM over G1 (Fp) and G2 (Fp2), the
//    port of zkevm_prover_tpu/ops/bn254_device.py _msm_device :390 (with
//    _all_window_digits :298, _segmented_bucket_sums :348 and
//    _bucket_reduce :380), which XLA fuses on the TPU. The JAX package
//    scans each window's sorted points with a log-depth segmented scan of
//    the group law (the TPU has no fast serial loop); here the prep kernel
//    writes each point's window digits as sort keys (window << c | digit;
//    digit 0, a zero scalar and the point at infinity sort last) and the
//    points in Montgomery form, torch.sort orders the keys (plumbing), and
//    one thread walks each chunk of a (window, bucket) segment with mixed
//    Jacobian + affine additions: a segment is cut into chunks of at most
//    L points (L = max(256, longest segment / 1024), so that a skewed
//    scalar set, a witness of bits or the top window's few digits, has no
//    thread walking a large share of the points alone), and one thread
//    per bucket adds its chunks' sums. The reduce kernel gives each window
//    one block of 128 threads: each thread a run of buckets (the running
//    sum and the weighted sum, lifted by the run's offset with a
//    double-and-add), the parts summed by a tree in shared memory; the
//    combine kernel joins the windows high to low with c doublings each
//    and returns the affine point in ordinary form.
//    Bound: operations, n * ceil(254 / c) mixed additions.
//  - fixed_base_kernel: k * G1 and k * G2 for a batch of scalars, what
//    groth16_setup's loops compute one at a time on the host
//    (zkevm_prover_tpu/snark/groth16.py:89-119 through ops/bn254.py
//    g1_mul_gen :434 / g2_mul_gen :532). The window table of the generator
//    (64 windows of 4 bits, 15 affine multiples each, Montgomery) sits in
//    shared memory; each thread takes a run of RUN scalars, adds one table
//    entry per nonzero digit, then normalises its run to affine with one
//    Fermat inversion (Montgomery's trick). Bound: operations, 64 mixed
//    additions a point plus the normalisation.
//  - fr_twiddle_kernel, fr_ntt_prologue_kernel, fr_ntt_shared_kernel,
//    fr_ntt_stage_kernel, fr_ntt_epilogue_kernel (the fr_ntt chain) and
//    fr_pointwise_kernel: bn254.fr_fft (ops/bn254.py:590) over the scalar
//    field, forward and inverse, natural order in and out, with an optional
//    coset shift x_i * g^i before it and y_i * h^i after it, and the
//    quotient's pointwise (a * b - c) * z (groth16.py _quotient_coeffs
//    :123). Radix-2 decimation in time: the prologue converts to Montgomery
//    form, shifts and writes in bit-reversed order; the first stages (up to
//    2^10 elements, 32 KiB) run in shared memory, one block per tile; each
//    later stage is one launch over n/2 butterflies. Bound: operations,
//    (n/2) log n butterflies of one product each.
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
constexpr int FB_BITS = 4;                       // fixed-base window
constexpr int FB_WINDOWS = 256 / FB_BITS;        // 64
constexpr int FB_ENTRIES = (1 << FB_BITS) - 1;   // 15 nonzero digits
constexpr int FB_RUN = 16;                       // scalars a thread normalises
constexpr int NTT_TILE_LOG = 10;                 // shared-memory stages

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

template <class F>
__device__ __forceinline__ void load_jac(Jac<F>& p, const uint32_t* src) {
  load(p.X, src);
  load(p.Y, src + words<F>());
  load(p.Z, src + 2 * words<F>());
}
template <class F>
__device__ __forceinline__ void store_jac(uint32_t* dst, const Jac<F>& p) {
  store(dst, p.X);
  store(dst + words<F>(), p.Y);
  store(dst + 2 * words<F>(), p.Z);
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

// keys[w * n + i] = w << c | digit_w(s_i), or nwin << c (last) for a zero
// digit, a zero scalar or the point at infinity; the points to Montgomery
template <class F>
__global__ void __launch_bounds__(THREADS)
    msm_prep_kernel(const uint32_t* __restrict__ pts,
                    const uint32_t* __restrict__ scalars, int64_t n, int c,
                    int nwin, int64_t* __restrict__ keys,
                    uint32_t* __restrict__ pts_mont) {
  const int64_t i = thread_id();
  if (i >= n) return;
  constexpr int W = words<F>();
  Aff<F> q;
  load(q.x, pts + i * 2 * W);
  load(q.y, pts + i * 2 * W + W);
  const bool inf = fis_zero(q.x) && fis_zero(q.y);
  mont_in(q.x);
  mont_in(q.y);
  store(pts_mont + i * 2 * W, q.x);
  store(pts_mont + i * 2 * W + W, q.y);
  uint32_t s[8];
  uint32_t any = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j] = scalars[i * 8 + j];
    any |= s[j];
  }
  const int64_t last = static_cast<int64_t>(nwin) << c;
  const uint32_t mask = (1u << c) - 1;
  for (int w = 0; w < nwin; ++w) {
    const int bit = w * c;
    const int word = bit >> 5, sh = bit & 31;
    uint32_t v = word < 8 ? s[word] >> sh : 0;
    if (sh && word + 1 < 8) v |= s[word + 1] << (32 - sh);
    const uint32_t d = v & mask;
    keys[w * n + i] = (inf || !any || d == 0)
                          ? last
                          : (static_cast<int64_t>(w) << c) | d;
  }
}

// chunk k: the sum of the points of sorted keys [starts[k], ends[k]), one
// thread each, mixed additions; Jacobian, Montgomery
template <class F>
__global__ void __launch_bounds__(THREADS)
    msm_bucket_kernel(const uint32_t* __restrict__ pts_mont,
                      const int64_t* __restrict__ order,
                      const int64_t* __restrict__ starts,
                      const int64_t* __restrict__ ends, int64_t nchunks,
                      int64_t n, uint32_t* __restrict__ partials) {
  const int64_t k = thread_id();
  if (k >= nchunks) return;
  constexpr int W = words<F>();
  Jac<F> acc;
  jac_set_inf(acc);
  const int64_t end = ends[k];
  for (int64_t j = starts[k]; j < end; ++j) {
    const int64_t i = order[j] % n;
    Aff<F> q;
    load(q.x, pts_mont + i * 2 * W);
    load(q.y, pts_mont + i * 2 * W + W);
    jac_add_mixed(acc, acc, q);
  }
  store_jac(partials + k * 3 * W, acc);
}

// bucket k: the sum of its chunks chunk_off[k] .. chunk_off[k + 1]
template <class F>
__global__ void __launch_bounds__(THREADS)
    msm_bucket_sum_kernel(const uint32_t* __restrict__ partials,
                          const int64_t* __restrict__ chunk_off,
                          int64_t nbuckets, uint32_t* __restrict__ buckets) {
  const int64_t k = thread_id();
  if (k >= nbuckets) return;
  constexpr int W = words<F>();
  Jac<F> acc, b;
  jac_set_inf(acc);
  const int64_t end = chunk_off[k + 1];
  for (int64_t ch = chunk_off[k]; ch < end; ++ch) {
    load_jac(b, partials + ch * 3 * W);
    jac_add(acc, acc, b);
  }
  store_jac(buckets + k * 3 * W, acc);
}

constexpr int REDUCE_THREADS = 128;

// window w (one block of REDUCE_THREADS): sum_b b * B[w][b]. Thread s
// takes buckets [lo, hi): running = sum B_b, acc = sum (b - lo + 1) B_b,
// and contributes acc + (lo - 1) * running; a tree in shared memory sums
// the parts
template <class F>
__global__ void __launch_bounds__(REDUCE_THREADS)
    msm_reduce_kernel(const uint32_t* __restrict__ buckets, int c,
                      uint32_t* __restrict__ windows) {
  __shared__ Jac<F> part[REDUCE_THREADS];
  constexpr int W = words<F>();
  const int w = blockIdx.x, s = threadIdx.x;
  const int nb = 1 << c;
  const int len = (nb - 1 + REDUCE_THREADS - 1) / REDUCE_THREADS;
  const int lo = 1 + s * len;
  const int hi = min(lo + len, nb);
  const uint32_t* base = buckets + static_cast<int64_t>(w) * nb * 3 * W;
  Jac<F> running, acc, b;
  jac_set_inf(running);
  jac_set_inf(acc);
  for (int k = hi - 1; k >= lo; --k) {
    load_jac(b, base + static_cast<int64_t>(k) * 3 * W);
    jac_add(running, running, b);
    jac_add(acc, acc, running);
  }
  if (lo < hi && lo > 1) {
    Jac<F> lift;
    jac_set_inf(lift);
    const uint32_t m = lo - 1;
    for (int bit = 31 - __clz(m); bit >= 0; --bit) {
      jac_double(lift, lift);
      if ((m >> bit) & 1) jac_add(lift, lift, running);
    }
    jac_add(acc, acc, lift);
  }
  part[s] = acc;
  __syncthreads();
  for (int half = REDUCE_THREADS / 2; half > 0; half >>= 1) {
    if (s < half) jac_add(part[s], part[s], part[s + half]);
    __syncthreads();
  }
  if (s == 0) store_jac(windows + static_cast<int64_t>(w) * 3 * W, part[0]);
}

// sum_w 2^(c w) * window_w, high to low, then affine, ordinary form
template <class F>
__global__ void msm_combine_kernel(const uint32_t* __restrict__ windows,
                                   int c, int nwin, uint32_t* __restrict__ out) {
  constexpr int W = words<F>();
  Jac<F> acc, win;
  load_jac(acc, windows + static_cast<int64_t>(nwin - 1) * 3 * W);
  for (int w = nwin - 2; w >= 0; --w) {
    for (int k = 0; k < c; ++k) jac_double(acc, acc);
    load_jac(win, windows + static_cast<int64_t>(w) * 3 * W);
    jac_add(acc, acc, win);
  }
  store_affine(out, acc);
}

// ---------------------------------------------------------------------------
// Fixed-base products k * G
// ---------------------------------------------------------------------------

template <class F>
__global__ void __launch_bounds__(THREADS)
    fixed_base_kernel(const uint32_t* __restrict__ table,
                      const uint32_t* __restrict__ scalars, int64_t n,
                      uint32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  constexpr int W = words<F>();
  constexpr int TABLE_WORDS = FB_WINDOWS * FB_ENTRIES * 2 * W;
  for (int t = threadIdx.x; t < TABLE_WORDS; t += blockDim.x)
    smem[t] = table[t];
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t run = thread_id(); run * FB_RUN < n; run += stride) {
    const int64_t first = run * FB_RUN;
    const int cnt = static_cast<int>(min(static_cast<int64_t>(FB_RUN),
                                         n - first));
    F zs[FB_RUN], pre[FB_RUN], prod;
    fset_one(prod);
#pragma unroll 1
    for (int k = 0; k < cnt; ++k) {
      const uint32_t* s = scalars + (first + k) * 8;
      Jac<F> acc;
      jac_set_inf(acc);
#pragma unroll 1
      for (int j = 0; j < FB_WINDOWS; ++j) {
        const uint32_t d = (s[j >> 3] >> ((j & 7) * FB_BITS)) & FB_ENTRIES;
        if (d) {
          Aff<F> q;
          const uint32_t* e = smem + (j * FB_ENTRIES + d - 1) * 2 * W;
          load(q.x, e);
          load(q.y, e + W);
          jac_add_mixed(acc, acc, q);
        }
      }
      uint32_t* o = out + (first + k) * 2 * W;
      store(o, acc.X);
      store(o + W, acc.Y);
      zs[k] = acc.Z;
      pre[k] = prod;
      if (!fis_zero(acc.Z)) fmul(prod, prod, acc.Z);
    }
    F inv;
    finv(inv, prod);
#pragma unroll 1
    for (int k = cnt - 1; k >= 0; --k) {
      uint32_t* o = out + (first + k) * 2 * W;
      F x, y;
      if (fis_zero(zs[k])) {
        fset_zero(x);
        fset_zero(y);
      } else {
        F zi, z2;
        fmul(zi, inv, pre[k]);
        fmul(inv, inv, zs[k]);
        load(x, o);
        load(y, o + W);
        fsq(z2, zi);
        fmul(x, x, z2);
        fmul(z2, z2, zi);
        fmul(y, y, z2);
        mont_out(x);
        mont_out(y);
      }
      store(o, x);
      store(o + W, y);
    }
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

__device__ __forceinline__ void butterfly(FrE& u, FrE& v, const FrE& w) {
  FrE t;
  fmul(t, v, w);
  fsub(v, u, t);
  fadd(u, u, t);
}

__global__ void __launch_bounds__(THREADS)
    fr_twiddle_kernel(uint32_t* __restrict__ tw, int64_t half, U8 omega) {
  const int64_t j = thread_id();
  if (j >= half) return;
  FrE r;
  fr_pow_small(r, fr_of(omega), static_cast<uint64_t>(j));
  store(tw + j * 8, r);
}

__global__ void __launch_bounds__(THREADS)
    fr_ntt_prologue_kernel(const uint32_t* __restrict__ in,
                           uint32_t* __restrict__ out, int64_t n, int logn,
                           U8 shift, int has_shift) {
  const int64_t i = thread_id();
  if (i >= n) return;
  FrE x;
  load(x, in + i * 8);
  to_mont(x, x);
  if (has_shift) {
    FrE g;
    fr_pow_small(g, fr_of(shift), static_cast<uint64_t>(i));
    fmul(x, x, g);
  }
  const uint64_t j =
      logn ? __brevll(static_cast<uint64_t>(i)) >> (64 - logn) : 0;
  store(out + j * 8, x);
}

// stages 1..tile_log of a tile of 2^tile_log elements, one block each,
// 2^(tile_log - 1) threads
__global__ void __launch_bounds__(1 << (NTT_TILE_LOG - 1))
    fr_ntt_shared_kernel(uint32_t* __restrict__ data,
                         const uint32_t* __restrict__ tw, int logn,
                         int tile_log) {
  __shared__ FrE tile[1 << NTT_TILE_LOG];
  const int T = 1 << tile_log;
  uint32_t* base = data + static_cast<int64_t>(blockIdx.x) * T * 8;
  for (int k = threadIdx.x; k < T; k += blockDim.x) load(tile[k], base + k * 8);
  __syncthreads();
  const int t = threadIdx.x;
  for (int s = 1; s <= tile_log; ++s) {
    const int h = 1 << (s - 1);
    const int l = t & (h - 1);
    const int i = ((t >> (s - 1)) << s) + l;
    FrE w;
    load(w, tw + (static_cast<int64_t>(l) << (logn - s)) * 8);
    butterfly(tile[i], tile[i + h], w);
    __syncthreads();
  }
  for (int k = threadIdx.x; k < T; k += blockDim.x) store(base + k * 8, tile[k]);
}

__global__ void __launch_bounds__(THREADS)
    fr_ntt_stage_kernel(uint32_t* __restrict__ data,
                        const uint32_t* __restrict__ tw, int64_t n, int logn,
                        int s) {
  const int64_t t = thread_id();
  if (t >= n / 2) return;
  const int64_t h = int64_t{1} << (s - 1);
  const int64_t l = t & (h - 1);
  const int64_t i = ((t >> (s - 1)) << s) + l;
  FrE u, v, w;
  load(u, data + i * 8);
  load(v, data + (i + h) * 8);
  load(w, tw + (l << (logn - s)) * 8);
  butterfly(u, v, w);
  store(data + i * 8, u);
  store(data + (i + h) * 8, v);
}

__global__ void __launch_bounds__(THREADS)
    fr_ntt_epilogue_kernel(const uint32_t* __restrict__ data,
                           uint32_t* __restrict__ out, int64_t n, U8 scale,
                           U8 post, int has_post) {
  const int64_t i = thread_id();
  if (i >= n) return;
  FrE x;
  load(x, data + i * 8);
  fmul(x, x, fr_of(scale));
  if (has_post) {
    FrE g;
    fr_pow_small(g, fr_of(post), static_cast<uint64_t>(i));
    fmul(x, x, g);
  }
  from_mont(x, x);
  store(out + i * 8, x);
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

template <class F>
int fixed_base_launch(const void* table, const void* scalars, long long n,
                      void* out, cudaStream_t st) {
  constexpr int bytes = FB_WINDOWS * FB_ENTRIES * 2 * words<F>() * 4;
  cudaError_t e = cudaFuncSetAttribute(
      fixed_base_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0, sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fixed_base_kernel<F>,
                                                THREADS, bytes);
  const int64_t runs = (n + FB_RUN - 1) / FB_RUN;
  int grid = blocks_for(runs);
  const int most = sms * (per_sm > 0 ? per_sm : 1);
  if (grid > most) grid = most;
  fixed_base_kernel<F><<<grid, THREADS, bytes, st>>>(
      static_cast<const uint32_t*>(table),
      static_cast<const uint32_t*>(scalars), n, static_cast<uint32_t*>(out));
  return status();
}

}  // namespace

#if BN254_G2
using G = G2F;
#else
using G = G1F;
#endif

extern "C" {

// FB_BITS, FB_WINDOWS, FB_RUN, NTT_TILE_LOG and the library's group (1 or
// 2): what the wrapper builds tables for and checks
int bn254_params(int* out) {
  out[0] = FB_BITS;
  out[1] = FB_WINDOWS;
  out[2] = FB_RUN;
  out[3] = NTT_TILE_LOG;
  out[4] = BN254_G2 ? 2 : 1;
  return 0;
}

int bn254_msm_prep(const void* pts, const void* scalars, long long n, int c,
                   int nwin, void* keys, void* pts_mont, void* stream) {
  if (n <= 0) return 0;
  msm_prep_kernel<G><<<blocks_for(n), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pts), static_cast<const uint32_t*>(scalars),
      n, c, nwin, static_cast<int64_t*>(keys),
      static_cast<uint32_t*>(pts_mont));
  return status();
}

// the chunks' sums, then each bucket's sum of its chunks
int bn254_msm_bucket(const void* pts_mont, const void* order,
                     const void* starts, const void* ends, long long nchunks,
                     long long n, void* partials, const void* chunk_off,
                     long long nbuckets, void* buckets, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto b = static_cast<uint32_t*>(partials);
  if (nchunks > 0) {
    msm_bucket_kernel<G><<<blocks_for(nchunks), THREADS, 0, st>>>(
        static_cast<const uint32_t*>(pts_mont),
        static_cast<const int64_t*>(order),
        static_cast<const int64_t*>(starts),
        static_cast<const int64_t*>(ends), nchunks, n, b);
    int err = status();
    if (err) return err;
  }
  msm_bucket_sum_kernel<G><<<blocks_for(nbuckets), THREADS, 0, st>>>(
      b, static_cast<const int64_t*>(chunk_off), nbuckets,
      static_cast<uint32_t*>(buckets));
  return status();
}

int bn254_msm_reduce(const void* buckets, int c, int nwin, void* windows,
                     void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto w = static_cast<uint32_t*>(windows);
  msm_reduce_kernel<G><<<nwin, REDUCE_THREADS, 0, st>>>(
      static_cast<const uint32_t*>(buckets), c, w);
  int e = status();
  if (e) return e;
  msm_combine_kernel<G><<<1, 1, 0, st>>>(w, c, nwin,
                                        static_cast<uint32_t*>(out));
  return status();
}

int bn254_fixed_base(const void* table, const void* scalars, long long n,
                     void* out, void* stream) {
  if (n <= 0) return 0;
  return fixed_base_launch<G>(table, scalars, n, out,
                              static_cast<cudaStream_t>(stream));
}

#if !BN254_G2

int bn254_fr_twiddles(void* tw, long long half, const void* omega,
                      void* stream) {
  if (half <= 0) return 0;
  fr_twiddle_kernel<<<blocks_for(half), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(tw), half, u8_of(omega));
  return status();
}

// the whole transform: prologue, shared stages, global stages, epilogue;
// `work` holds n Montgomery elements between them
int bn254_fr_ntt(const void* in, void* out, void* work, const void* tw,
                 long long n, int logn, const void* shift, int has_shift,
                 const void* scale, const void* post, int has_post,
                 void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto wk = static_cast<uint32_t*>(work);
  auto t = static_cast<const uint32_t*>(tw);
  fr_ntt_prologue_kernel<<<blocks_for(n), THREADS, 0, st>>>(
      static_cast<const uint32_t*>(in), wk, n, logn, u8_of(shift), has_shift);
  int e = status();
  if (e) return e;
  const int tile_log = logn < NTT_TILE_LOG ? logn : NTT_TILE_LOG;
  if (tile_log > 0) {
    fr_ntt_shared_kernel<<<static_cast<int>(n >> tile_log),
                           1 << (tile_log - 1), 0, st>>>(wk, t, logn,
                                                         tile_log);
    if ((e = status())) return e;
  }
  for (int s = tile_log + 1; s <= logn; ++s) {
    fr_ntt_stage_kernel<<<blocks_for(n / 2), THREADS, 0, st>>>(wk, t, n, logn,
                                                                s);
    if ((e = status())) return e;
  }
  fr_ntt_epilogue_kernel<<<blocks_for(n), THREADS, 0, st>>>(
      wk, static_cast<uint32_t*>(out), n, u8_of(scale), u8_of(post), has_post);
  return status();
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
