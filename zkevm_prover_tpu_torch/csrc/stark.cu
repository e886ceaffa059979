// The STARK prover's row programs and grand products (sm_90a), one library
// with a plain C interface (ops/stark_cuda.py binds it with ctypes).
//
// Replaces device programs of the JAX package that XLA fuses on the TPU
// (none is a pallas_call):
//  - dag_eval_kernel: zkevm_prover_tpu/stark/expr.py eval_array as the
//    prover's phases trace it into XLA programs: the lookups' f and t
//    (stark/prover.py _phase2_run), the grand products' partial products,
//    num and den (_phase3_group_run), the quotient C * Zi on the extended
//    coset (_phase4_chunk_fns) and the FRI polynomial's two evMap Horner
//    sums (_phase5_fri_chunk_fns); also check_constraints' per-constraint
//    test;
//  - grand_product: stark/prover.py calculate_z with ops/gl3.py
//    batch_inverse and ops/goldilocks.py scan_mul: z_0 = 1,
//    z_i = prod_{j<i} num_j / den_j in GL3.
// Each is bit-identical to its plain twin (stark/dag.py run_plain,
// stark/prover.py calculate_z) for canonical inputs.
//
// Design.
//  - dag_eval_kernel is an interpreter: one thread per row walks one
//    instruction list (stark/dag.py compiles the expression DAG to it) and
//    keeps its values in a per-thread slot array (local memory; the
//    compiler orders the DAG so that a thousand-constraint program needs a
//    few slots). Every thread of a warp runs the same instruction, so the
//    switch never diverges. Instructions are int4 (op, dst, a, b); an
//    operand >= 0 is a slot, < 0 an entry of the uniform table (values
//    that are the same on every row: challenges, publics, numbers, evals
//    and what the host folded from them). Loads read a section's column on
//    the row or on row + prime_stride (mod rows); stores write an output
//    column; flags raise an int where a value is not zero. Row-major
//    sections make a warp's loads strided (width * 8 bytes apart): a
//    shared-memory row tile that coalesces them is later work.
//  - grand_product runs three passes over every argument at once (grid y
//    = argument): (1) each thread takes ROWS_PER_THREAD consecutive rows,
//    forms num * den^-1 (the inverse by the adjugate and a Fermat base
//    inverse, per element), its exclusive prefix products within the
//    thread, and a block-wide scan of the thread totals gives each row its
//    exclusive product within the block; a zero den raises the argument's
//    flag; (2) one block per argument scans the block totals; (3) each row
//    takes its block's carry, or, under a raised flag, z = (1, 0, ...): the
//    batch inversion's total inverse is inv(0) = 0 there, so every ratio
//    and every z after the first is 0. GL3 products are exact, associative
//    and commutative, so the scan's order gives the same bytes.
//
// What bounds them on the H100: the interpreter's field products (a GL3
// product is 9 widening 64-bit products here, at least 6 by Karatsuba) and
// its instruction issue; the grand product's per-element inverse (a 64-step
// Fermat chain) against 72 bytes an element (chip_smoke.dag_bound /
// grand_product_bound count the least: products at the IMAD rate against
// every column read and every output written once).
#include <cuda_runtime.h>

#include <cstdint>

#include "goldilocks.cuh"

namespace {

constexpr int MAX_SLOTS = 32;       // stark/dag.py MAX_SLOTS
constexpr int MAX_SECTIONS = 8;     // stark/dag.py MAX_SECTIONS
constexpr int THREADS = 128;
constexpr int GP_THREADS = 256;
constexpr int ROWS_PER_THREAD = 4;
constexpr int GP_ROWS = GP_THREADS * ROWS_PER_THREAD;
constexpr uint64_t P = gl::P;
constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 mod p

// stark/dag.py opcodes
enum Op : int {
  LOAD1 = 0, LOAD3 = 1, LOAD1_NEXT = 2, LOAD3_NEXT = 3,
  STORE1 = 4, STORE3 = 5, STORE13 = 6, FLAG1 = 7, FLAG3 = 8,
  NEG1 = 9, NEG3 = 10, ADD = 16, SUB = 20, MUL = 24
};

struct Sections {
  const uint64_t* ptr[MAX_SECTIONS];
  long long stride[MAX_SECTIONS];   // u64 words between rows
};

// ---- canonical field operations: ops/goldilocks.py's formulas -----------

__device__ __forceinline__ uint64_t f_add(uint64_t a, uint64_t b) {
  const uint64_t s = a + b;
  return (s < a || s >= P) ? s + EPS : s;
}
__device__ __forceinline__ uint64_t f_sub(uint64_t a, uint64_t b) {
  const uint64_t d = a - b;
  return a < b ? d - EPS : d;
}
__device__ __forceinline__ uint64_t f_neg(uint64_t a) {
  return a == 0 ? 0 : P - a;
}
__device__ __forceinline__ uint64_t f_mul(uint64_t a, uint64_t b) {
  return gl::canonical(gl::mul_lazy(a, b));
}

// GL3 = GL[x] / (x^3 - x - 1): (a0 + a1 x + a2 x^2)(b0 + b1 x + b2 x^2) with
// x^3 = x + 1, x^4 = x^2 + x; each coefficient one sum of products on a
// 160-bit accumulator, reduced once.
__device__ __forceinline__ void f3_mul(const uint64_t a[3],
                                       const uint64_t b[3], uint64_t r[3]) {
  uint32_t c0[5] = {0, 0, 0, 0, 0}, c1[5] = {0, 0, 0, 0, 0},
           c2[5] = {0, 0, 0, 0, 0};
  gl::mul_acc(c0, a[0], b[0]);
  gl::mul_acc(c0, a[1], b[2]);
  gl::mul_acc(c0, a[2], b[1]);
  gl::mul_acc(c1, a[0], b[1]);
  gl::mul_acc(c1, a[1], b[0]);
  gl::mul_acc(c1, a[1], b[2]);
  gl::mul_acc(c1, a[2], b[1]);
  gl::mul_acc(c1, a[2], b[2]);
  gl::mul_acc(c2, a[0], b[2]);
  gl::mul_acc(c2, a[1], b[1]);
  gl::mul_acc(c2, a[2], b[0]);
  gl::mul_acc(c2, a[2], b[2]);
  r[0] = gl::canonical(gl::reduce_words(c0[0], c0[1], c0[2], c0[3], c0[4]));
  r[1] = gl::canonical(gl::reduce_words(c1[0], c1[1], c1[2], c1[3], c1[4]));
  r[2] = gl::canonical(gl::reduce_words(c2[0], c2[1], c2[2], c2[3], c2[4]));
}

// a^(p-2) (0 for a = 0): square-and-multiply on lazy values.
__device__ uint64_t f_inv(uint64_t a) {
  const uint64_t e = P - 2;
  uint64_t r = 1, b = a;
  for (int i = 0; i < 64; ++i) {
    if ((e >> i) & 1) r = gl::mul_lazy(r, b);
    b = gl::square_lazy(b);
  }
  return gl::canonical(r);
}

// ops/gl3.py inv: the adjugate of multiplication by a, over its
// determinant.
__device__ void f3_inv(const uint64_t a[3], uint64_t r[3]) {
  const uint64_t m11 = f_add(a[0], a[2]), m12 = f_add(a[1], a[2]);
  const uint64_t cof00 = f_sub(f_mul(m11, m11), f_mul(m12, a[1]));
  const uint64_t cof10 = f_neg(f_sub(f_mul(a[1], m11), f_mul(m12, a[2])));
  const uint64_t cof20 = f_sub(f_mul(a[1], a[1]), f_mul(m11, a[2]));
  const uint64_t det = f_add(f_add(f_mul(a[0], cof00), f_mul(a[2], cof10)),
                             f_mul(a[1], cof20));
  const uint64_t d = f_inv(det);
  r[0] = f_mul(cof00, d);
  r[1] = f_mul(cof10, d);
  r[2] = f_mul(cof20, d);
}

// ---- kernel A: the row-program interpreter ------------------------------

// Operand x (a slot or a uniform entry) into v; a base value fills v[0]
// and, with `widen`, zeros v[1..2].
__device__ __forceinline__ void fetch(uint64_t v[3], int x, bool ext,
                                      bool widen, uint64_t (*slot)[3],
                                      const uint64_t* __restrict__ uni) {
  const uint64_t* p = x >= 0 ? slot[x] : uni + 3 * (-1 - x);
  v[0] = p[0];
  if (ext) {
    v[1] = p[1];
    v[2] = p[2];
  } else if (widen) {
    v[1] = 0;
    v[2] = 0;
  }
}

__global__ void __launch_bounds__(THREADS)
    dag_eval_kernel(const int4* __restrict__ code, int n_ops,
                    const uint64_t* __restrict__ uni, Sections sec,
                    uint64_t* __restrict__ out, long long out_stride,
                    int* __restrict__ flags, long long rows,
                    long long prime_stride) {
  const long long row = blockIdx.x * static_cast<long long>(THREADS) +
                        threadIdx.x;
  if (row >= rows) return;
  const long long next = (row + prime_stride) % rows;
  uint64_t slot[MAX_SLOTS][3];
  uint64_t* o = out + row * out_stride;
  for (int i = 0; i < n_ops; ++i) {
    const int4 ins = __ldg(code + i);
    const int op = ins.x;
    if (op <= LOAD3_NEXT) {
      const long long r = (op & 2) ? next : row;
      const uint64_t* p = sec.ptr[ins.z] + r * sec.stride[ins.z] + ins.w;
      slot[ins.y][0] = p[0];
      if (op & 1) {
        slot[ins.y][1] = p[1];
        slot[ins.y][2] = p[2];
      }
      continue;
    }
    uint64_t a[3], b[3];
    switch (op) {
      case STORE1:
        fetch(a, ins.z, false, false, slot, uni);
        o[ins.w] = a[0];
        break;
      case STORE3:
      case STORE13:
        fetch(a, ins.z, op == STORE3, true, slot, uni);
        o[ins.w] = a[0];
        o[ins.w + 1] = a[1];
        o[ins.w + 2] = a[2];
        break;
      case FLAG1:
      case FLAG3:
        fetch(a, ins.z, op == FLAG3, true, slot, uni);
        if (a[0] | a[1] | a[2]) flags[ins.w] = 1;
        break;
      case NEG1:
      case NEG3:
        fetch(a, ins.z, op == NEG3, false, slot, uni);
        slot[ins.y][0] = f_neg(a[0]);
        if (op == NEG3) {
          slot[ins.y][1] = f_neg(a[1]);
          slot[ins.y][2] = f_neg(a[2]);
        }
        break;
      default: {
        const int kind = op & ~3;
        const bool ea = op & 2, eb = op & 1;
        if (kind == MUL) {
          fetch(a, ins.z, ea, false, slot, uni);
          fetch(b, ins.w, eb, false, slot, uni);
          uint64_t* d = slot[ins.y];
          if (ea && eb) {
            uint64_t r[3];
            f3_mul(a, b, r);
            d[0] = r[0];
            d[1] = r[1];
            d[2] = r[2];
          } else if (ea) {          // gl3.mul_base(a, b)
            d[0] = f_mul(a[0], b[0]);
            d[1] = f_mul(a[1], b[0]);
            d[2] = f_mul(a[2], b[0]);
          } else if (eb) {          // gl3.mul_base(b, a)
            d[0] = f_mul(b[0], a[0]);
            d[1] = f_mul(b[1], a[0]);
            d[2] = f_mul(b[2], a[0]);
          } else {
            d[0] = f_mul(a[0], b[0]);
          }
        } else {                    // ADD / SUB: a base operand of an
                                    // extension one promotes to (v, 0, 0)
          const bool e = ea || eb;
          fetch(a, ins.z, ea, e, slot, uni);
          fetch(b, ins.w, eb, e, slot, uni);
          uint64_t* d = slot[ins.y];
          const int n = e ? 3 : 1;
          for (int k = 0; k < n; ++k)
            d[k] = kind == ADD ? f_add(a[k], b[k]) : f_sub(a[k], b[k]);
        }
      }
    }
  }
}

// ---- kernel B: the grand products --------------------------------------

// One argument of grand_product: 8 int64s (ops/stark_cuda.py _gp_table).
struct GpArg {
  const uint64_t* num;
  long long num_stride;
  long long num_dim;
  const uint64_t* den;
  long long den_stride;
  long long den_dim;
  uint64_t* z;
  long long z_stride;
};

__device__ __forceinline__ void load3(const uint64_t* p, long long dim,
                                      uint64_t v[3]) {
  v[0] = p[0];
  v[1] = dim == 3 ? p[1] : 0;
  v[2] = dim == 3 ? p[2] : 0;
}

__device__ __forceinline__ void copy3(const uint64_t a[3], uint64_t r[3]) {
  r[0] = a[0];
  r[1] = a[1];
  r[2] = a[2];
}

// Exclusive scan of each thread's v over the block (Hillis-Steele on
// shared memory): returns the product of the threads before this one in
// excl and the block's product in total.
__device__ void block_scan(uint64_t (*sh)[3], const uint64_t v[3],
                           uint64_t excl[3], uint64_t total[3]) {
  const int t = threadIdx.x;
  copy3(v, sh[t]);
  __syncthreads();
  for (int off = 1; off < GP_THREADS; off *= 2) {
    uint64_t r[3];
    if (t >= off) {
      f3_mul(sh[t - off], sh[t], r);
    } else {
      copy3(sh[t], r);
    }
    __syncthreads();
    copy3(r, sh[t]);
    __syncthreads();
  }
  if (t > 0) {
    copy3(sh[t - 1], excl);
  } else {
    excl[0] = 1;
    excl[1] = 0;
    excl[2] = 0;
  }
  copy3(sh[GP_THREADS - 1], total);
  __syncthreads();
}

// pass 1: z_i = the product of the block's ratios before row i; the
// block's total into totals[arg][block]; a zero den raises flags[arg].
__global__ void __launch_bounds__(GP_THREADS)
    gp_block_kernel(const GpArg* __restrict__ args, long long n,
                    uint64_t* __restrict__ totals, int* __restrict__ flags) {
  __shared__ uint64_t sh[GP_THREADS][3];
  const GpArg g = args[blockIdx.y];
  const long long first = blockIdx.x * static_cast<long long>(GP_ROWS) +
                          threadIdx.x * static_cast<long long>(ROWS_PER_THREAD);
  uint64_t pre[ROWS_PER_THREAD][3];
  uint64_t acc[3] = {1, 0, 0};
  bool zero = false;
  for (int e = 0; e < ROWS_PER_THREAD; ++e) {
    copy3(acc, pre[e]);
    const long long row = first + e;
    if (row >= n) continue;
    uint64_t num[3], den[3], inv[3], ratio[3], t[3];
    load3(g.num + row * g.num_stride, g.num_dim, num);
    load3(g.den + row * g.den_stride, g.den_dim, den);
    if ((den[0] | den[1] | den[2]) == 0) zero = true;
    if (g.den_dim == 1) {
      inv[0] = f_inv(den[0]);
      inv[1] = 0;
      inv[2] = 0;
    } else {
      f3_inv(den, inv);
    }
    f3_mul(num, inv, ratio);
    f3_mul(acc, ratio, t);
    copy3(t, acc);
  }
  if (zero) flags[blockIdx.y] = 1;
  uint64_t excl[3], total[3];
  block_scan(sh, acc, excl, total);
  for (int e = 0; e < ROWS_PER_THREAD; ++e) {
    const long long row = first + e;
    if (row >= n) break;
    uint64_t r[3];
    f3_mul(excl, pre[e], r);
    uint64_t* z = g.z + row * g.z_stride;
    z[0] = r[0];
    z[1] = r[1];
    z[2] = r[2];
  }
  if (threadIdx.x == 0) {
    uint64_t* t = totals + 3 * (blockIdx.y * static_cast<long long>(gridDim.x)
                                + blockIdx.x);
    copy3(total, t);
  }
}

// pass 2: totals[arg][b] <- the product of totals[arg][< b] (one block per
// argument; each thread scans a run of consecutive blocks).
__global__ void __launch_bounds__(GP_THREADS)
    gp_carry_kernel(uint64_t* __restrict__ totals, long long n_blocks) {
  __shared__ uint64_t sh[GP_THREADS][3];
  uint64_t* t = totals + 3 * blockIdx.x * n_blocks;
  const long long per = (n_blocks + GP_THREADS - 1) / GP_THREADS;
  const long long lo = threadIdx.x * per;
  const long long hi = lo + per < n_blocks ? lo + per : n_blocks;
  uint64_t acc[3] = {1, 0, 0};
  for (long long b = lo; b < hi; ++b) {
    uint64_t r[3];
    f3_mul(acc, t + 3 * b, r);
    copy3(r, acc);
  }
  uint64_t carry[3], total[3];
  block_scan(sh, acc, carry, total);
  for (long long b = lo; b < hi; ++b) {
    uint64_t old[3], r[3];
    copy3(t + 3 * b, old);
    copy3(carry, t + 3 * b);
    f3_mul(carry, old, r);
    copy3(r, carry);
  }
}

// pass 3: each row times its block's carry; z = (1, 0, 0), 0, ... where
// the argument's flag is raised.
__global__ void __launch_bounds__(GP_THREADS)
    gp_apply_kernel(const GpArg* __restrict__ args, long long n,
                    const uint64_t* __restrict__ totals,
                    const int* __restrict__ flags) {
  const GpArg g = args[blockIdx.y];
  const bool zero = flags[blockIdx.y] != 0;
  if (!zero && blockIdx.x == 0) return;
  uint64_t carry[3];
  copy3(totals + 3 * (blockIdx.y * static_cast<long long>(gridDim.x) +
                      blockIdx.x), carry);
  const long long first = blockIdx.x * static_cast<long long>(GP_ROWS) +
                          threadIdx.x * static_cast<long long>(ROWS_PER_THREAD);
  for (int e = 0; e < ROWS_PER_THREAD; ++e) {
    const long long row = first + e;
    if (row >= n) break;
    uint64_t* z = g.z + row * g.z_stride;
    if (zero) {
      z[0] = row == 0 ? 1 : 0;
      z[1] = 0;
      z[2] = 0;
    } else {
      uint64_t v[3], r[3];
      copy3(z, v);
      f3_mul(carry, v, r);
      copy3(r, z);
    }
  }
}

}  // namespace

// The program `code` ((n_ops, 4) int32) over `rows` rows: the uniform table
// `uni` ((n, 3) u64), n_sections section pointers with their row strides
// (host arrays), the output and its row stride, the flags (int32, may be
// null when the program raises none). Returns the cudaError of the launch.
extern "C" int stark_dag_eval(const void* code, int n_ops, const void* uni,
                              const void* const* section_ptrs,
                              const long long* section_strides,
                              int n_sections, void* out, long long out_stride,
                              void* flags, long long rows,
                              long long prime_stride, void* stream) {
  if (rows <= 0 || n_ops <= 0) return 0;
  if (n_sections > MAX_SECTIONS) return static_cast<int>(cudaErrorInvalidValue);
  Sections sec = {};
  for (int i = 0; i < n_sections; ++i) {
    sec.ptr[i] = static_cast<const uint64_t*>(section_ptrs[i]);
    sec.stride[i] = section_strides[i];
  }
  const long long blocks = (rows + THREADS - 1) / THREADS;
  dag_eval_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(code), n_ops,
      static_cast<const uint64_t*>(uni), sec, static_cast<uint64_t*>(out),
      out_stride, static_cast<int*>(flags), rows, prime_stride);
  return static_cast<int>(cudaGetLastError());
}

// z of n_args arguments of n rows each (`args`: a device table of GpArg),
// with the scratch `totals` ((n_args, ceil(n / 1024), 3) u64) and `flags`
// ((n_args,) int32, zeroed by the caller). Returns the cudaError of the
// launches.
extern "C" int stark_grand_product(const void* args, int n_args, long long n,
                                   void* totals, void* flags, void* stream) {
  if (n <= 0 || n_args <= 0) return 0;
  const long long n_blocks = (n + GP_ROWS - 1) / GP_ROWS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_blocks),
                  static_cast<unsigned>(n_args));
  const GpArg* a = static_cast<const GpArg*>(args);
  uint64_t* t = static_cast<uint64_t*>(totals);
  int* f = static_cast<int*>(flags);
  gp_block_kernel<<<grid, GP_THREADS, 0, s>>>(a, n, t, f);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  gp_carry_kernel<<<static_cast<unsigned>(n_args), GP_THREADS, 0, s>>>(
      t, n_blocks);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  gp_apply_kernel<<<grid, GP_THREADS, 0, s>>>(a, n, t, f);
  return static_cast<int>(cudaGetLastError());
}
