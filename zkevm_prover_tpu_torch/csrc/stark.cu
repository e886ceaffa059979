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
//  - dag_eval_kernel is an interpreter: each thread runs one instruction
//    list (stark/dag.py compiles the expression DAG to it) over RPT rows
//    at once (two independent dependency chains for the scheduler to
//    overlap); every thread of a block runs the same instruction, so the
//    switch never diverges. A persistent grid (the blocks that fit on the
//    card at once) walks tiles of TILE rows. For each tile a block
//      1. gathers the program's leaf words (the columns it reads, each on
//         its row or on the next one, listed once by the compiler) from
//         the row-major sections into its own column-major scratch region
//         [word][row]: cp.async copies adjacent columns of a row into a
//         padded shared-memory stage, double-buffered, and the block writes
//         whole TILE-row runs of a word out of it;
//      2. interprets the program: an operand is a slot, a leaf word (a
//         coalesced 256-byte read of the scratch per warp, row and word)
//         or an entry of the uniform table (values that are the same on
//         every row: challenges, publics, numbers, evals and what the host
//         folded from them). A product and the sum that alone reads it are
//         one instruction (a * b + c, a * b - c, c - a * b). Instructions
//         whose operands are all base (three in four of C * Zi's) take a
//         one-limb path ahead of the general one.
//    Values live in a slot file in dynamic shared memory laid out
//    [slot][limb][row]: a warp's access of one slot is 32 adjacent words,
//    with no bank conflict and no local-memory stack frame; the gather
//    stages through the same bytes. The uniform table stays in device
//    memory and is read through the read-only cache (every lane of a warp
//    reads one address: a broadcast), so it may have any size; the
//    instruction stream (one 64-bit word an instruction) is staged through
//    two shared-memory buffers of CODE_CHUNK instructions with cp.async,
//    the next chunk in flight while the block runs the current one.
//    Shared memory per block: 8 * (max(3 * slots, 2 * stage * (TILE + 1)
//    / TILE) * TILE + 2 * CODE_CHUNK) bytes, sized at launch (at most
//    200,704 at MAX_SLOTS); the scratch is blocks * leaf words * TILE
//    words.
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
// product is 6 widening 64-bit products by Karatsuba over x^3 - x - 1, one
// reduction per coefficient; 12 before the Hopper redesign), its
// instruction issue and its reads of the leaf scratch (each leaf read where
// it is used: on the combined AIR's C * Zi about 16 times a word); the
// grand product's per-element inverse (a 64-step Fermat chain) against 72
// bytes an element (chip_smoke.dag_bound / grand_product_bound count the
// least: products at the IMAD rate against every column read and every
// output written once).
#include <cuda_runtime.h>

#include <cstdint>

#include "goldilocks.cuh"

namespace {

constexpr int MAX_SLOTS = 32;       // stark/dag.py MAX_SLOTS: operands
                                    // from here on are leaf words
constexpr int TILE = 256;           // rows of one tile
constexpr int RPT = 2;              // rows of a tile each thread runs
constexpr int THREADS = TILE / RPT; // thread t runs rows t + q * THREADS
constexpr int MIN_BLOCKS = 4;       // blocks an SM holds (128 registers)
constexpr int WARPS = THREADS / 32;
constexpr int CODE_CHUNK = 256;     // instructions of one staged chunk,
static_assert(CODE_CHUNK % THREADS == 0, "whole instructions a thread");
constexpr int GP_THREADS = 256;
constexpr int ROWS_PER_THREAD = 4;
constexpr int GP_ROWS = GP_THREADS * ROWS_PER_THREAD;
constexpr uint64_t P = gl::P;
constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 mod p

// stark/dag.py opcodes; MADD, MSUB, SUBM: a * b + c, a * b - c, c - a * b
enum Op : int {
  STORE1 = 4, STORE3 = 5, STORE13 = 6, FLAG1 = 7, FLAG3 = 8,
  NEG1 = 9, NEG3 = 10, ADD = 16, SUB = 20, MUL = 24, MADD = 32, MSUB = 40,
  SUBM = 48
};

// One leaf word of a program (ops/stark_cuda.py builds the table from
// stark/dag.py Program.leaves): its column's first element, the section's
// row stride in u64 words, and 1 where the word is read on the next row.
struct Leaf {
  const uint64_t* col;
  long long stride;
  long long next;
};

// Shared memory of one dag_eval_kernel block, in u64 words: the slot file
// (also the gather's two stages of `stage` words by TILE + 1 rows) and two
// code buffers.
struct DagLayout {
  int stage;
  int slot_words;
  long long bytes() const { return 8ll * (slot_words + 2 * CODE_CHUNK); }
};
// the largest block (MAX_SLOTS slots) fits the H100's 227 KB a block
static_assert(8 * (3 * MAX_SLOTS * TILE + 2 * CODE_CHUNK) <= 227 * 1024,
              "the slot file of MAX_SLOTS slots must fit a block");

DagLayout dag_layout(int n_slots) {
  DagLayout d;
  const int limbs = 3 * n_slots;   // the largest two stages the file holds,
  d.stage = 32;                    // at least 4 words each
  while (d.stage > 4 && limbs * TILE < 2 * d.stage * (TILE + 1))
    d.stage /= 2;
  const int file = limbs * TILE, stage = 2 * d.stage * (TILE + 1);
  d.slot_words = file > stage ? file : stage;
  return d;
}

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

// (r3:r2:r1:r0) = a * b, the whole 128-bit product: four 32x32 partial
// products on a mad.cc / madc carry chain (gl::mul_lazy's, unreduced).
__device__ __forceinline__ void mul_wide(uint32_t r[4], uint64_t a,
                                         uint64_t b) {
  const uint32_t a0 = gl::lo32(a), a1 = gl::hi32(a), b0 = gl::lo32(b),
                 b1 = gl::hi32(b);
  asm("mul.lo.u32     %0, %4, %6;\n\t"
      "mul.hi.u32     %1, %4, %6;\n\t"
      "mad.lo.cc.u32  %1, %4, %7, %1;\n\t"
      "madc.hi.u32    %2, %4, %7, %8;\n\t"
      "mad.lo.cc.u32  %1, %5, %6, %1;\n\t"
      "madc.hi.cc.u32 %2, %5, %6, %2;\n\t"
      "madc.hi.u32    %3, %5, %7, %8;\n\t"
      "mad.lo.cc.u32  %2, %5, %7, %2;\n\t"
      "addc.u32       %3, %3, %8;\n\t"
      : "=&r"(r[0]), "=&r"(r[1]), "=&r"(r[2]), "=&r"(r[3])
      : "r"(a0), "r"(a1), "r"(b0), "r"(b1), "r"(0u));
}

// (c4:c3:c2:c1:c0) += m, -= m for a 128-bit m (no wrap: the callers keep
// the sum within [0, 2^160)).
__device__ __forceinline__ void acc_add(uint32_t c[5], const uint32_t m[4]) {
  asm("add.cc.u32  %0, %0, %5;\n\t"
      "addc.cc.u32 %1, %1, %6;\n\t"
      "addc.cc.u32 %2, %2, %7;\n\t"
      "addc.cc.u32 %3, %3, %8;\n\t"
      "addc.u32    %4, %4, 0;\n\t"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3]), "+r"(c[4])
      : "r"(m[0]), "r"(m[1]), "r"(m[2]), "r"(m[3]));
}
__device__ __forceinline__ void acc_sub(uint32_t c[5], const uint32_t m[4]) {
  asm("sub.cc.u32  %0, %0, %5;\n\t"
      "subc.cc.u32 %1, %1, %6;\n\t"
      "subc.cc.u32 %2, %2, %7;\n\t"
      "subc.cc.u32 %3, %3, %8;\n\t"
      "subc.u32    %4, %4, 0;\n\t"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3]), "+r"(c[4])
      : "r"(m[0]), "r"(m[1]), "r"(m[2]), "r"(m[3]));
}

// GL3 = GL[x] / (x^3 - x - 1): (a0 + a1 x + a2 x^2)(b0 + b1 x + b2 x^2)
// by Karatsuba, six widening products m_i = a_i b_i and m_ij = (a_i +
// a_j)(b_i + b_j) (the sums reduced first, so every m < p^2). With x^3 =
// x + 1 and x^4 = x^2 + x the coefficients are
//   r0 = m0 + m12 - m1 - m2,  r1 = m01 + m12 - m0 - 2 m1,
//   r2 = m02 + m1 - m0,
// each summed on a 160-bit accumulator that starts at 2p^2, 3p^2 and p^2
// (multiples of p that keep every partial sum above 0 in the order below
// and the total below 5p^2 < 2^131) and reduced once. Each product goes
// into the sums as soon as it is formed, so one is live at a time.
__device__ __forceinline__ void f3_mul(const uint64_t a[3],
                                       const uint64_t b[3], uint64_t r[3]) {
  // k p^2 as 32-bit words, low first
  uint32_t c0[5] = {2u, 0xFFFFFFFCu, 5u, 0xFFFFFFFCu, 1u};
  uint32_t c1[5] = {3u, 0xFFFFFFFAu, 8u, 0xFFFFFFFAu, 2u};
  uint32_t c2[5] = {1u, 0xFFFFFFFEu, 2u, 0xFFFFFFFEu, 0u};
  uint32_t m[4];
  mul_wide(m, a[0], b[0]);
  acc_add(c0, m);
  acc_sub(c1, m);
  acc_sub(c2, m);
  mul_wide(m, a[1], b[1]);
  acc_sub(c0, m);
  acc_sub(c1, m);
  acc_sub(c1, m);
  acc_add(c2, m);
  mul_wide(m, a[2], b[2]);
  acc_sub(c0, m);
  mul_wide(m, f_add(a[0], a[1]), f_add(b[0], b[1]));
  acc_add(c1, m);
  mul_wide(m, f_add(a[0], a[2]), f_add(b[0], b[2]));
  acc_add(c2, m);
  mul_wide(m, f_add(a[1], a[2]), f_add(b[1], b[2]));
  acc_add(c0, m);
  acc_add(c1, m);
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

__device__ __forceinline__ void cp_async8(uint64_t* dst, const uint64_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// all but the last committed group
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// A 17-bit two's complement field of an instruction word.
__device__ __forceinline__ int field17(uint64_t w, int shift) {
  return static_cast<int>(static_cast<uint32_t>(w >> shift) << 15) >> 15;
}

// Where a thread's operands live: its column of the slot file and of its
// block's leaf scratch (row stride TILE in both; its q-th row THREADS * q
// further), and the uniform table in device memory.
struct Frame {
  uint64_t* slot;
  const uint64_t* leaf;
  const uint64_t* uni;
};

// Operand x into v (one value per row of the thread): a slot (0 <= x <
// MAX_SLOTS), a leaf word (x >= MAX_SLOTS) or a uniform entry (x < 0). A
// base value fills v[q][0] and, with `widen`, zeros v[q][1..2]. x is the
// same on every thread of the block, so the branches never diverge.
__device__ __forceinline__ void fetch(uint64_t v[RPT][3], int x, bool ext,
                                      bool widen, const Frame& f) {
  if (x >= MAX_SLOTS) {
    const uint64_t* p = f.leaf + (x - MAX_SLOTS) * TILE;
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      v[q][0] = p[q * THREADS];
      if (ext) {
        v[q][1] = p[TILE + q * THREADS];
        v[q][2] = p[2 * TILE + q * THREADS];
      }
    }
  } else if (x >= 0) {
    const uint64_t* p = f.slot + 3 * x * TILE;
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      v[q][0] = p[q * THREADS];
      if (ext) {
        v[q][1] = p[TILE + q * THREADS];
        v[q][2] = p[2 * TILE + q * THREADS];
      }
    }
  } else {
    const uint64_t* p = f.uni + 3 * (-1 - x);
    const uint64_t u0 = __ldg(p);
    const uint64_t u1 = ext ? __ldg(p + 1) : 0;
    const uint64_t u2 = ext ? __ldg(p + 2) : 0;
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      v[q][0] = u0;
      if (ext) {
        v[q][1] = u1;
        v[q][2] = u2;
      }
    }
  }
  if (!ext && widen) {
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      v[q][1] = 0;
      v[q][2] = 0;
    }
  }
}

// A base operand x of each row into v (fetch for a value of dim 1).
__device__ __forceinline__ void fetch1(uint64_t v[RPT], int x,
                                       const Frame& f) {
  if (x >= MAX_SLOTS) {
    const uint64_t* p = f.leaf + (x - MAX_SLOTS) * TILE;
#pragma unroll
    for (int q = 0; q < RPT; ++q) v[q] = p[q * THREADS];
  } else if (x >= 0) {
    const uint64_t* p = f.slot + 3 * x * TILE;
#pragma unroll
    for (int q = 0; q < RPT; ++q) v[q] = p[q * THREADS];
  } else {
    const uint64_t u = __ldg(f.uni + 3 * (-1 - x));
#pragma unroll
    for (int q = 0; q < RPT; ++q) v[q] = u;
  }
}

// r = a * b for a of dim 3 when ea, b of dim 3 when eb (dag.py MUL).
__device__ __forceinline__ void product(const uint64_t a[3],
                                        const uint64_t b[3], bool ea,
                                        bool eb, uint64_t r[3]) {
  if (ea && eb) {
    f3_mul(a, b, r);
  } else if (ea) {          // gl3.mul_base(a, b)
    r[0] = f_mul(a[0], b[0]);
    r[1] = f_mul(a[1], b[0]);
    r[2] = f_mul(a[2], b[0]);
  } else if (eb) {          // gl3.mul_base(b, a)
    r[0] = f_mul(b[0], a[0]);
    r[1] = f_mul(b[1], a[0]);
    r[2] = f_mul(b[2], a[0]);
  } else {
    r[0] = f_mul(a[0], b[0]);
  }
}

// r = a + b or a - b, over 3 limbs when e (a base operand of an extension
// one already widened to (v, 0, 0)).
__device__ __forceinline__ void sum(const uint64_t a[3], const uint64_t b[3],
                                    bool sub, bool e, uint64_t r[3]) {
  if (sub) {
    r[0] = f_sub(a[0], b[0]);
    if (e) {
      r[1] = f_sub(a[1], b[1]);
      r[2] = f_sub(a[2], b[2]);
    }
  } else {
    r[0] = f_add(a[0], b[0]);
    if (e) {
      r[1] = f_add(a[1], b[1]);
      r[2] = f_add(a[2], b[2]);
    }
  }
}

// One instruction word for the thread's rows (`o[q]` the output row of
// row q, `live[q]` false past the last row: it stores and flags nothing).
// A result goes to slot dst.
__device__ __forceinline__ void step(uint64_t ins, const Frame& f,
                                     uint64_t* const o[RPT],
                                     const bool live[RPT], int* flags) {
  const int op = static_cast<int>(ins & 0x3F);
  const int dst = static_cast<int>((ins >> 6) & 0x3F);
  const int xa = field17(ins, 12), xb = field17(ins, 29);
  if (op >= MADD ? (op & 7) == 0 : op >= ADD && (op & 3) == 0) {
    // every operand base: the program's common case, on one limb
    uint64_t a1[RPT], b1[RPT], r1[RPT];
    fetch1(a1, xa, f);
    fetch1(b1, xb, f);
    const int kind = op >= MADD ? op : op & ~3;
    if (kind == ADD || kind == SUB) {
#pragma unroll
      for (int q = 0; q < RPT; ++q)
        r1[q] = kind == SUB ? f_sub(a1[q], b1[q]) : f_add(a1[q], b1[q]);
    } else {
#pragma unroll
      for (int q = 0; q < RPT; ++q) r1[q] = f_mul(a1[q], b1[q]);
      if (kind != MUL) {
        fetch1(b1, field17(ins, 46), f);
#pragma unroll
        for (int q = 0; q < RPT; ++q)
          r1[q] = kind == MADD ? f_add(r1[q], b1[q])
                               : (kind == MSUB ? f_sub(r1[q], b1[q])
                                               : f_sub(b1[q], r1[q]));
      }
    }
    uint64_t* d = f.slot + 3 * dst * TILE;
#pragma unroll
    for (int q = 0; q < RPT; ++q) d[q * THREADS] = r1[q];
    return;
  }
  uint64_t a[RPT][3], b[RPT][3], r[RPT][3];
  bool e;
  const bool fused = op >= MADD;
  if (fused || (op & ~3) == MUL) {  // a * b, then + c, - c or c - (fused)
    const bool ea = op & (fused ? 4 : 2), eb = op & (fused ? 2 : 1);
    fetch(a, xa, ea, false, f);
    fetch(b, xb, eb, false, f);
#pragma unroll
    for (int q = 0; q < RPT; ++q) product(a[q], b[q], ea, eb, r[q]);
    e = ea || eb;
    if (fused) {
      const bool ec = op & 1, em = e;
      e = em || ec;
      if (e && !em) {
#pragma unroll
        for (int q = 0; q < RPT; ++q) {
          r[q][1] = 0;
          r[q][2] = 0;
        }
      }
      fetch(b, field17(ins, 46), ec, e, f);
      const bool subm = (op & ~7) == SUBM, msub = (op & ~7) == MSUB;
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        if (subm)
          sum(b[q], r[q], true, e, r[q]);
        else
          sum(r[q], b[q], msub, e, r[q]);
      }
    }
  } else {
    switch (op) {
      case STORE1:
        fetch(a, xa, false, false, f);
#pragma unroll
        for (int q = 0; q < RPT; ++q)
          if (live[q]) o[q][xb] = a[q][0];
        return;
      case STORE3:
      case STORE13:
        fetch(a, xa, op == STORE3, true, f);
#pragma unroll
        for (int q = 0; q < RPT; ++q) {
          if (live[q]) {
            o[q][xb] = a[q][0];
            o[q][xb + 1] = a[q][1];
            o[q][xb + 2] = a[q][2];
          }
        }
        return;
      case FLAG1:
      case FLAG3:
        fetch(a, xa, op == FLAG3, true, f);
#pragma unroll
        for (int q = 0; q < RPT; ++q)
          if (live[q] && (a[q][0] | a[q][1] | a[q][2])) flags[xb] = 1;
        return;
      case NEG1:
      case NEG3:
        e = op == NEG3;
        fetch(a, xa, e, false, f);
#pragma unroll
        for (int q = 0; q < RPT; ++q) {
          r[q][0] = f_neg(a[q][0]);
          if (e) {
            r[q][1] = f_neg(a[q][1]);
            r[q][2] = f_neg(a[q][2]);
          }
        }
        break;
      default: {                    // ADD / SUB: a base operand of an
                                    // extension one promotes to (v, 0, 0)
        const bool ea = op & 2, eb = op & 1;
        e = ea || eb;
        fetch(a, xa, ea, e, f);
        fetch(b, xb, eb, e, f);
#pragma unroll
        for (int q = 0; q < RPT; ++q)
          sum(a[q], b[q], (op & ~3) == SUB, e, r[q]);
      }
    }
  }
  uint64_t* d = f.slot + 3 * dst * TILE;
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    d[q * THREADS] = r[q][0];
    if (e) {
      d[TILE + q * THREADS] = r[q][1];
      d[2 * TILE + q * THREADS] = r[q][2];
    }
  }
}

// Tile `row0`'s leaf words into the block's scratch [word][TILE], a step
// of `stage` words (4, 8, 16 or 32) at a time through two stage buffers
// [word][TILE + 1] in the slot file's bytes: lane l of a warp copies word
// l mod stage of 32 / stage rows at once (adjacent lanes on adjacent
// columns of a row) with cp.async, every copy of a step in flight at once
// and the next step's copies in flight while the block writes the last
// step's TILE rows of each word out, a warp 256 bytes at once (the stage's
// row stride TILE + 1 puts a half-warp's 16 words in 16 bank pairs).
__device__ __forceinline__ void gather(const Leaf* __restrict__ leaves,
                                       int n_words, int stage,
                                       uint64_t* sh, uint64_t* scratch,
                                       long long row0, long long rows,
                                       long long prime_stride) {
  const int t = threadIdx.x, lane = t & 31;
  const int lg = 31 - __clz(stage);
  const int j = lane & (stage - 1);
  const int per = 32 >> lg;                  // rows a warp copies at once
  const int r_first = (t >> 5) * per + (lane >> lg);
  const int r_step = WARPS * per;            // rows the block copies at once
  const int buf_words = stage * (TILE + 1);
  auto issue = [&](int w0, uint64_t* st) {
    if (w0 + j < n_words) {
      const Leaf lf = leaves[w0 + j];
      for (int r = r_first; r < TILE && row0 + r < rows; r += r_step) {
        long long row = row0 + r;
        if (lf.next) {
          row += prime_stride;
          if (row >= rows) row -= rows;
        }
        cp_async8(st + j * (TILE + 1) + r, lf.col + row * lf.stride);
      }
    }
    cp_async_commit();
  };
  issue(0, sh);
  for (int w0 = 0, b = 0; w0 < n_words; w0 += stage, b ^= 1) {
    issue(w0 + stage, sh + (b ^ 1) * buf_words);
    cp_async_wait_prior();        // this step's copies are in
    __syncthreads();
    const uint64_t* st = sh + b * buf_words;
    const int nw = n_words - w0 < stage ? n_words - w0 : stage;
    for (int k = 0; k < nw; ++k)
#pragma unroll
      for (int q = 0; q < RPT; ++q)
        scratch[(w0 + k) * static_cast<long long>(TILE) + q * THREADS + t] =
            st[k * (TILE + 1) + q * THREADS + t];
    __syncthreads();              // the buffer is free for the step after
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    dag_eval_kernel(const uint64_t* __restrict__ code, int n_ops,
                    const uint64_t* __restrict__ uni,
                    const Leaf* __restrict__ leaves, int n_words, int stage,
                    int slot_words, uint64_t* __restrict__ scratch,
                    uint64_t* __restrict__ out, long long out_stride,
                    int* __restrict__ flags, long long rows,
                    long long prime_stride) {
  extern __shared__ uint64_t smem[];
  uint64_t* const sh_slot = smem;
  uint64_t* const sh_code = smem + slot_words;
  const int t = threadIdx.x;
  uint64_t* const mine = scratch + static_cast<long long>(blockIdx.x) *
                                       n_words * TILE;
  const Frame f{sh_slot + t, mine + t, uni};
  const long long tiles = (rows + TILE - 1) / TILE;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * TILE;
    __syncthreads();              // the last tile's reads are done
    gather(leaves, n_words, stage, sh_slot, mine, row0, rows, prime_stride);
    bool live[RPT];
    uint64_t* o[RPT];
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const long long row = row0 + q * THREADS + t;
      live[q] = row < rows;
      o[q] = out + (live[q] ? row * out_stride : 0);
    }
    auto stage_code = [&](int c0, uint64_t* buf) {
#pragma unroll
      for (int k = t; k < CODE_CHUNK; k += THREADS)
        if (c0 + k < n_ops) cp_async8(buf + k, code + c0 + k);
      cp_async_commit();
    };
    stage_code(0, sh_code);
    for (int c0 = 0, buf = 0; c0 < n_ops; c0 += CODE_CHUNK, buf ^= 1) {
      cp_async_wait_all();
      __syncthreads();            // chunk c0 is in, chunk c0 - 1 is done
      const uint64_t* cur = sh_code + buf * CODE_CHUNK;
      stage_code(c0 + CODE_CHUNK, sh_code + (buf ^ 1) * CODE_CHUNK);
      const int n = n_ops - c0 < CODE_CHUNK ? n_ops - c0 : CODE_CHUNK;
      for (int i = 0; i < n; ++i) step(cur[i], f, o, live, flags);
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

// dag_eval_kernel's launch for a program of n_slots (<= MAX_SLOTS) slots
// over `rows` rows: its dynamic shared memory per block (*smem, bytes), its
// persistent grid (*grid: the blocks that fit on the card at once, at most
// one per tile) and the leaf words of one gather step (*stage). Returns
// the cudaError of the queries.
extern "C" int stark_dag_plan(int n_slots, long long rows, long long* smem,
                              int* grid, int* stage) {
  const DagLayout d = dag_layout(n_slots);
  *smem = d.bytes();
  *stage = d.stage;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dag_eval_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(*smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dag_eval_kernel, THREADS, static_cast<size_t>(*smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (rows + TILE - 1) / TILE;
  const long long resident = static_cast<long long>(sms) * per_sm;
  *grid = static_cast<int>(tiles < resident ? tiles : resident);
  return 0;
}

// The program `code` (n_ops instruction words) over `rows` rows on `grid`
// blocks (stark_dag_plan's): the uniform table `uni` ((n, 3) u64), the
// leaf table `leaves` (n_words Leaf entries), the scratch (grid * n_words
// * TILE u64), the output and its row stride, the flags (int32, may be
// null when the program raises none). Returns the cudaError of the launch.
extern "C" int stark_dag_eval(const void* code, int n_ops, const void* uni,
                              int n_slots, const void* leaves,
                              int n_words, void* scratch, int grid,
                              void* out, long long out_stride, void* flags,
                              long long rows, long long prime_stride,
                              void* stream) {
  if (rows <= 0 || n_ops <= 0) return 0;
  const DagLayout d = dag_layout(n_slots);
  cudaError_t err = cudaFuncSetAttribute(
      dag_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(d.bytes()));
  if (err != cudaSuccess) return static_cast<int>(err);
  dag_eval_kernel<<<static_cast<unsigned>(grid), THREADS, d.bytes(),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(code), n_ops,
      static_cast<const uint64_t*>(uni),
      static_cast<const Leaf*>(leaves), n_words, d.stage, d.slot_words,
      static_cast<uint64_t*>(scratch), static_cast<uint64_t*>(out),
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
