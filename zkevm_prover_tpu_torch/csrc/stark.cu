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
//  - grand_product is one kernel launch over every argument (up to
//    GP_MAX_ARGS a launch; the table is a kernel parameter) and writes z
//    once: a block is one warp and one tile of GP_LANES * GP_RUN rows of one
//    argument, taken from an atomic ticket counter, argument fastest, so
//    the blocks running at once read the same rows of a shared num/den
//    section and its sectors come from DRAM once. The warp stages the
//    tile's num and den with cp.async (adjacent words of a few rows a
//    copy), each lane runs GP_RUN consecutive rows with Montgomery's trick
//    (forward products of num and den, one inverse of the run's den
//    product, a backward sweep: four products an element and a share of
//    one inverse, base products where den or num is base), the warp scans
//    its lanes' ratios with shuffles, and a chained scan with decoupled
//    look-back gives the tile its exclusive prefix: each tile publishes its
//    aggregate, then its inclusive prefix, under a status word that carries
//    the launch's epoch, so the scratch is never reset between launches.
//    A zero den anywhere in an argument makes calculate_z's batch
//    inversion return inv(0) = 0 for the total, z = (1, 0, ...): the tiles
//    raise the argument's flag and the launch's last block rewrites its z.
//    GL3 products are exact, associative and commutative, so the order of
//    the products gives the same bytes.
//
// What bounds them on the H100: the interpreter's field products (a GL3
// product is 6 widening 64-bit products by Karatsuba over x^3 - x - 1, one
// reduction per coefficient; 12 before the Hopper redesign), its
// instruction issue and its reads of the leaf scratch (each leaf read where
// it is used: on the combined AIR's C * Zi about 16 times a word); the
// grand product's field products (four GL3 products an element, the run's
// inverse: 64 squarings and 9 products of an addition chain, the warp
// scan's 5 products a lane) against 72 bytes an element (chip_smoke.
// dag_bound / grand_product_bound count the least: products at the IMAD
// rate against every column read and every output written once).
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
constexpr int GP_LANES = 32;        // threads of a grand-product block
constexpr int GP_RUN = 16;          // consecutive rows of one lane
constexpr int GP_MIN_BLOCKS = 16;   // blocks an SM holds (128 registers)
constexpr int GP_MAX_ARGS = 64;     // arguments of one launch
constexpr int GP_ENTRY = 8;         // u64 words of a tile's look-back entry
constexpr int GP_LOOK = 4;          // entries a lane reads a look-back step
constexpr int GP_BATCH = 8;         // 8-byte loads a lane has in flight
// u64 words of a lane's run of GP_RUN elements of w words in shared memory
__host__ __device__ constexpr int gp_pitch(int w) { return GP_RUN * w + 2; }
constexpr int GP_HEAD = 4 + GP_MAX_ARGS;  // scratch words before the entries:
                                    // ticket, done, epoch, 0, zero flags
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

// x^(2^k), lazy.
__device__ __forceinline__ uint64_t f_sqn(uint64_t x, int k) {
#pragma unroll 1
  for (int i = 0; i < k; ++i) x = gl::square_lazy(x);
  return x;
}

// a^(p-2) (0 for a = 0) by an addition chain on lazy values, 64 squarings
// and 9 products: with x_k = a^(2^k - 1), p - 2 = 2^64 - 2^32 - 1 =
// (2^31 - 1) 2^33 + (2^32 - 1), so a^(p-2) = x31^(2^33) x32.
__device__ uint64_t f_inv(uint64_t a) {
  const uint64_t x2 = gl::mul_lazy(gl::square_lazy(a), a);
  const uint64_t x3 = gl::mul_lazy(gl::square_lazy(x2), a);
  const uint64_t x6 = gl::mul_lazy(f_sqn(x3, 3), x3);
  const uint64_t x12 = gl::mul_lazy(f_sqn(x6, 6), x6);
  const uint64_t x24 = gl::mul_lazy(f_sqn(x12, 12), x12);
  const uint64_t x30 = gl::mul_lazy(f_sqn(x24, 6), x6);
  const uint64_t x31 = gl::mul_lazy(gl::square_lazy(x30), a);
  const uint64_t x32 = gl::mul_lazy(gl::square_lazy(x31), a);
  return gl::canonical(gl::mul_lazy(f_sqn(x31, 33), x32));
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
__device__ __forceinline__ void cp_async16(uint64_t* dst,
                                           const uint64_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
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

// One argument of a launch (ops/stark_cuda.py grand_product's table row):
// its columns' first elements, row strides in u64 words, dims (1 or 3) and
// whether an element's num and den words are one 16-byte aligned run (a
// num/den section's layout: each row's element is one vector load).
struct GpArg {
  const uint64_t* num;
  const uint64_t* den;
  uint64_t* z;
  long long num_stride;
  long long den_stride;
  long long z_stride;
  int dims;     // num dim * 4 + den dim
  int paired;   // den = num + num dim words, 16-byte aligned, one stride
};

// A launch's parameters: the argument table travels in the kernel's
// parameter space (GP_MAX_ARGS * 56 bytes, under the 4 KB of any CUDA 12),
// so nothing is copied to the card before the launch.
struct GpParams {
  GpArg arg[GP_MAX_ARGS];
  uint64_t* scratch;
  long long n;
  long long tiles;
  int n_args;
};

constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ uint64_t ld_cg(const uint64_t* p) {
  return static_cast<uint64_t>(
      __ldcg(reinterpret_cast<const unsigned long long*>(p)));
}
__device__ __forceinline__ uint64_t ld_nc(const uint64_t* p) {
  return static_cast<uint64_t>(
      __ldg(reinterpret_cast<const unsigned long long*>(p)));
}
__device__ __forceinline__ void st_cg(uint64_t* p, uint64_t v) {
  __stcg(reinterpret_cast<unsigned long long*>(p),
         static_cast<unsigned long long>(v));
}
__device__ __forceinline__ uint64_t ld_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(uint64_t* p, uint64_t v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

// Kernel B's single GL3 products: one copy of f3_mul's code, which every
// phase calls. Inlined at each of the kernel's dozen sites, the phases'
// code outgrew the instruction cache, and warps in different phases of
// their tiles stalled on instruction fetch. The runs' paired products
// (g_mul2), two independent chains, are inlined in their two loops.
struct F3 {
  uint64_t v0, v1, v2;
};
__device__ __noinline__ F3 f3_mul_call(F3 a, F3 b) {
  const uint64_t x[3] = {a.v0, a.v1, a.v2}, y[3] = {b.v0, b.v1, b.v2};
  uint64_t r[3];
  f3_mul(x, y, r);
  return F3{r[0], r[1], r[2]};
}

// Values of dim D (1: base, 3: GL3) as arrays.
template <int D>
__device__ __forceinline__ void g_one(uint64_t* r) {
  r[0] = 1;
  if constexpr (D == 3) r[1] = r[2] = 0;
}
template <int D>
__device__ __forceinline__ void g_copy(const uint64_t* a, uint64_t* r) {
#pragma unroll
  for (int i = 0; i < D; ++i) r[i] = a[i];
}
// r = a * b, of dim max(A, B); r may be a or b when it has that dim.
template <int A, int B>
__device__ __forceinline__ void g_mul(const uint64_t* a, const uint64_t* b,
                                      uint64_t* r) {
  if constexpr (A == 3 && B == 3) {
    const F3 m = f3_mul_call(F3{a[0], a[1], a[2]}, F3{b[0], b[1], b[2]});
    r[0] = m.v0;
    r[1] = m.v1;
    r[2] = m.v2;
  } else if constexpr (A == 3) {
    const uint64_t s = b[0];
    r[0] = f_mul(a[0], s);
    r[1] = f_mul(a[1], s);
    r[2] = f_mul(a[2], s);
  } else if constexpr (B == 3) {
    const uint64_t s = a[0];
    r[0] = f_mul(s, b[0]);
    r[1] = f_mul(s, b[1]);
    r[2] = f_mul(s, b[2]);
  } else {
    r[0] = f_mul(a[0], b[0]);
  }
}
// r = a * b and s = c * d (dims A x B and C x E), both from the operands
// as they were; r and s may be any of them. Two GL3 products are inlined
// side by side, so that their instructions interleave.
template <int A, int B, int C, int E>
__device__ __forceinline__ void g_mul2(const uint64_t* a, const uint64_t* b,
                                       uint64_t* r, const uint64_t* c,
                                       const uint64_t* d, uint64_t* s) {
  if constexpr (A == 3 && B == 3 && C == 3 && E == 3) {
    uint64_t t[3], u[3];
    f3_mul(a, b, t);
    f3_mul(c, d, u);
    g_copy<3>(t, r);
    g_copy<3>(u, s);
  } else {
    constexpr int RA = A > B ? A : B, RC = C > E ? C : E;
    uint64_t t[RA], u[RC];
    g_mul<A, B>(a, b, t);
    g_mul<C, E>(c, d, u);
    g_copy<RA>(t, r);
    g_copy<RC>(u, s);
  }
}
template <int D>
__device__ __forceinline__ void g_inv(const uint64_t* a, uint64_t* r) {
  if constexpr (D == 3) {
    f3_inv(a, r);
  } else {
    r[0] = f_inv(a[0]);
  }
}
template <int D>
__device__ __forceinline__ bool g_zero(const uint64_t* a) {
  if constexpr (D == 3) return (a[0] | a[1] | a[2]) == 0;
  return a[0] == 0;
}
template <int D>
__device__ __forceinline__ void g_shfl_up(const uint64_t* a, uint64_t* r,
                                          int off) {
#pragma unroll
  for (int i = 0; i < D; ++i) r[i] = __shfl_up_sync(FULL, a[i], off);
}
template <int D>
__device__ __forceinline__ void g_shfl_xor(const uint64_t* a, uint64_t* r,
                                           int mask) {
#pragma unroll
  for (int i = 0; i < D; ++i) r[i] = __shfl_xor_sync(FULL, a[i], mask);
}
template <int D>
__device__ __forceinline__ void g_shfl(const uint64_t* a, uint64_t* r,
                                       int lane) {
#pragma unroll
  for (int i = 0; i < D; ++i) r[i] = __shfl_sync(FULL, a[i], lane);
}

// A tile's look-back entry (GP_ENTRY words): the status (epoch << 2 |
// state: 1 the aggregate is out, 2 the inclusive prefix too), the
// aggregate's 3 words, the inclusive prefix's 3 words. The values are
// stored before the status with release order, so a reader that sees a
// status of this epoch and then fences reads the values it names.
template <int D>
__device__ __forceinline__ void gp_publish(uint64_t* entry, const uint64_t* v,
                                           uint64_t epoch, int state) {
  uint64_t* dst = entry + (state == 2 ? 4 : 1);
#pragma unroll
  for (int i = 0; i < 3; ++i) st_cg(dst + i, i < D ? v[i] : 0);
  st_release(entry, epoch << 2 | static_cast<uint64_t>(state));
}

// The product of the ratios of every tile before `tile` of one argument
// (D: their dim), by decoupled look-back over the argument's entries, a
// window of GP_LOOK * GP_LANES tiles at a time: lane i reads the entries
// of tiles base - i - GP_LANES j (j < GP_LOOK), waiting until each is
// published in this epoch (a tile of a smaller ticket, so one already
// running); the nearest tile that holds an inclusive prefix ends the walk
// and tiles past it count 1. Each lane multiplies what it read into its
// own product, window after window (only the rows of entries up to the
// inclusive), and the warp multiplies the lanes' products once at the end
// (only as many butterfly steps as lanes hold a value). Tiles before
// tile 0 read as an inclusive prefix of 1.
template <int D>
__device__ void gp_look_back(const uint64_t* entries, long long tile,
                             uint64_t epoch, int lane, uint64_t carry[D]) {
  constexpr int WINDOW = GP_LOOK * GP_LANES;
  g_one<D>(carry);
  int span = 0;            // lanes holding a product other than 1
  for (long long base = tile - 1;; base -= WINDOW) {
    // the statuses, all loads in flight at once (a tile before 0 reads as
    // an inclusive prefix), then one fence orders the values' reads
    const uint64_t ready = epoch << 2 | 2;
    uint64_t s[GP_LOOK];
#pragma unroll
    for (int j = 0; j < GP_LOOK; ++j) {
      const long long idx = base - lane - GP_LANES * j;
      s[j] = idx >= 0 ? ld_relaxed(entries + idx * GP_ENTRY) : ready;
    }
#pragma unroll
    for (int j = 0; j < GP_LOOK; ++j) {
      const uint64_t* e = entries + (base - lane - GP_LANES * j) * GP_ENTRY;
      while ((s[j] >> 2) != epoch || (s[j] & 3) == 0) {
        __nanosleep(32);
        s[j] = ld_relaxed(e);
      }
    }
    __threadfence();
    unsigned inc = 0;      // bit j: the lane's entry j holds an inclusive
    int stop = WINDOW;     // the nearest inclusive's offset in the window
#pragma unroll
    for (int j = 0; j < GP_LOOK; ++j) {
      const bool inclusive = (s[j] & 3) == 2;
      inc |= static_cast<unsigned>(inclusive) << j;
      const unsigned b = __ballot_sync(FULL, inclusive);
      if (b && stop == WINDOW) stop = GP_LANES * j + __ffs(b) - 1;
    }
    // the values up to the nearest inclusive (stop is the warp's: rows j
    // of entries past it are skipped by every lane)
    uint64_t v[GP_LOOK][D];
#pragma unroll
    for (int j = 0; j < GP_LOOK; ++j) {
      const long long idx = base - lane - GP_LANES * j;
      g_one<D>(v[j]);
      if (GP_LANES * j > stop) break;
      if (idx < 0 || GP_LANES * j + lane > stop) continue;
      const uint64_t* src = entries + idx * GP_ENTRY + ((inc >> j) & 1 ? 4 : 1);
#pragma unroll
      for (int i = 0; i < D; ++i) v[j][i] = ld_cg(src + i);
    }
#pragma unroll
    for (int j = 0; j < GP_LOOK; ++j) {
      if (GP_LANES * j > stop) break;
      g_mul<D, D>(carry, v[j], carry);
    }
    if (stop < WINDOW) {
      if (span < GP_LANES) span = stop + 1 < GP_LANES ? stop + 1 : GP_LANES;
      break;
    }
    span = GP_LANES;
  }
  // the lanes' products: lanes from `span` on hold 1, so the butterfly's
  // first ceil(log2(span)) steps give lane 0 the whole product
#pragma unroll 1
  for (int off = 1; off < span; off *= 2) {
    uint64_t o[D];
    g_shfl_xor<D>(carry, o, off);
    g_mul<D, D>(carry, o, carry);
  }
  g_shfl<D>(carry, carry, 0);
}

// z of row r (3 words; RD of them from v, the rest 0) unless r >= n.
template <int RD>
__device__ __forceinline__ void gp_store(uint64_t* z, long long stride,
                                         long long r, long long n,
                                         const uint64_t* v) {
  if (r >= n) return;
  uint64_t* p = z + r * stride;
  p[0] = v[0];
  if constexpr (RD == 3) {
    p[1] = v[1];
    p[2] = v[2];
  } else {
    p[1] = p[2] = 0;
  }
}

// One tile (GP_LANES * RUN rows, RUN = GP_RUN) of one argument, num of dim
// ND, den of dim DD, on one warp: lane l runs rows l * RUN .. l * RUN + RUN
// - 1 of it.
//  1. The warp stages the tile's num and den words in shared memory, the
//     lanes on adjacent words of a few rows: a paired argument (each
//     element's W words one 16-byte aligned run, as in a num/den section)
//     with 16-byte cp.async, all of the tile in flight at once; any other
//     with 8-byte loads, GP_BATCH a lane in flight. Each lane's run is RUN
//     slots of W words in a row of PITCH words (RUN * W + 2: the slots
//     16-byte aligned, the lanes' 8-byte accesses of a slot at most two to
//     a bank). Rows past n stage as num = den = 1.
//  2. Forward over the run: D_k = d_0 ... d_k and N_k = n_0 ... n_k (the
//     two products one call), N_k written over n_k; the run's ratio N / D
//     through one inverse I of D_{RUN-1} (GL3: the adjugate over a base
//     inverse; base den: a base inverse, and base products).
//  3. The warp's inclusive scan of the runs' ratios (__shfl_up, RD limbs);
//     the warp's total is the tile's aggregate.
//  4. The tile's exclusive prefix: tile 0 publishes its inclusive prefix
//     at once, any other its aggregate, then looks back and publishes its
//     inclusive prefix.
//  5. Backward over the run from S = carry / D_{RUN-1}, carry the product
//     of every row before the run: S_k = S_{k+1} d_k is carry / D_{k-1}
//     and z_k = N_{k-1} S_k, paired in one call with the next S; z of the
//     run's first row is the carry. Each z row is stored as it is formed.
// Four products an element, two calls of two. A zero den gives D = 0, I =
// 0 and zero ratios from there on; it raises the argument's zero flag, and
// the launch's last block rewrites z.
template <int ND, int DD>
__device__ __forceinline__ void gp_tile(const GpArg& g, long long n,
                                        long long tile, uint64_t* entries,
                                        uint64_t* zero_flag, uint64_t epoch,
                                        uint64_t* sh, int lane) {
  constexpr int W = ND + DD;
  constexpr int RD = ND == 3 || DD == 3 ? 3 : 1;
  constexpr int RUN = GP_RUN;
  constexpr int PITCH = gp_pitch(W);
  constexpr int ROWS = GP_LANES * RUN;
  // the argument's fields once into registers: read in the loops, each
  // would be a dynamically indexed constant load
  const uint64_t* const num = g.num;
  const uint64_t* const den = g.den;
  uint64_t* const z_out = g.z;
  const long long ns = g.num_stride, ds = g.den_stride, zs = g.z_stride;
  const long long row0 = tile * ROWS;
  if (g.paired) {
    // lane = part + C * sub: 16-byte part `part` of rows sub, sub + R, ...
    constexpr int C = W / 2, R = GP_LANES / C;
    const int part = lane % C, sub = lane / C, w = 2 * part;
    if (sub < R) {
      const uint64_t* src = num + (row0 + sub) * ns + w;
#pragma unroll 4
      for (int row = sub; row < ROWS; row += R, src += R * ns) {
        uint64_t* dst = sh + (row / RUN) * PITCH + (row % RUN) * W + w;
        if (row0 + row < n) {
          cp_async16(dst, src);
        } else {
          dst[0] = w == 0 || w == ND;
          dst[1] = w + 1 == ND;
        }
      }
    }
    cp_async_commit();
    cp_async_wait_all();
  } else {
    // lane = w + W * sub: word w of rows sub, sub + R, ..., GP_BATCH
    // loads in flight
    constexpr int R = GP_LANES / W;
    const int w = lane % W, sub = lane / W;
    if (sub < R) {
      const bool of_num = w < ND;
      const uint64_t* const src = of_num ? num + w : den + (w - ND);
      const long long st = of_num ? ns : ds;
      const uint64_t pad = w == 0 || w == ND;
#pragma unroll 1
      for (int row = sub; row < ROWS; row += R * GP_BATCH) {
        uint64_t v[GP_BATCH];
#pragma unroll
        for (int b = 0; b < GP_BATCH; ++b) {
          const int rr = row + R * b;
          v[b] = rr < ROWS && row0 + rr < n ? ld_nc(src + (row0 + rr) * st)
                                            : pad;
        }
#pragma unroll
        for (int b = 0; b < GP_BATCH; ++b) {
          const int rr = row + R * b;
          if (rr < ROWS) sh[(rr / RUN) * PITCH + (rr % RUN) * W + w] = v[b];
        }
      }
    }
  }
  __syncwarp();

  uint64_t* run = sh + lane * PITCH;
  uint64_t D[DD], N[ND];
  g_one<DD>(D);
  g_one<ND>(N);
#pragma unroll 1
  for (int k = 0; k < RUN; ++k) {
    uint64_t* s = run + k * W;
    g_mul2<DD, DD, ND, ND>(D, s + ND, D, N, s, N);
    g_copy<ND>(N, s);
  }
  const bool zero = g_zero<DD>(D);
  uint64_t I[DD], incl[RD];
  g_inv<DD>(D, I);
  g_mul<ND, DD>(N, I, incl);

#pragma unroll 1
  for (int off = 1; off < GP_LANES; off *= 2) {
    uint64_t o[RD];
    g_shfl_up<RD>(incl, o, off);
    if (lane >= off) g_mul<RD, RD>(o, incl, incl);
  }
  uint64_t excl[RD], agg[RD];
  g_shfl_up<RD>(incl, excl, 1);
  if (lane == 0) g_one<RD>(excl);
  g_shfl<RD>(incl, agg, GP_LANES - 1);
  if (__any_sync(FULL, zero) && lane == 0) st_cg(zero_flag, epoch + 1);

  uint64_t* mine = entries + tile * GP_ENTRY;
  uint64_t carry[RD];
  if (tile == 0) {
    if (lane == 0) gp_publish<RD>(mine, agg, epoch, 2);
    g_one<RD>(carry);
  } else {
    if (lane == 0) gp_publish<RD>(mine, agg, epoch, 1);
    gp_look_back<RD>(entries, tile, epoch, lane, carry);
    if (lane == 0) {
      uint64_t t[RD];
      g_mul<RD, RD>(carry, agg, t);
      gp_publish<RD>(mine, t, epoch, 2);
    }
  }

  const long long first = row0 + lane * RUN;
  g_mul<RD, RD>(carry, excl, carry);
  uint64_t S[RD], z[RD];
  g_mul<RD, DD>(carry, I, S);
  g_mul<RD, DD>(S, run + (RUN - 1) * W + ND, S);
#pragma unroll 1
  for (int k = RUN - 2; k >= 1; --k) {
    const uint64_t* s = run + k * W;
    g_mul2<RD, DD, ND, RD>(S, s + ND, S, s, S, z);
    gp_store<RD>(z_out, zs, first + k + 1, n, z);
  }
  g_mul<ND, RD>(run, S, z);
  gp_store<RD>(z_out, zs, first + 1, n, z);
  gp_store<RD>(z_out, zs, first, n, carry);
}

// Every argument of a launch: one warp a block and a tile a block, the
// tile and argument from a ticket of an atomic counter (argument fastest,
// so the blocks running at once read the same rows of a shared section and
// a tile's ticket comes after its predecessor's: the look-back never waits
// on a block that has not started). The launch's last block (a second
// counter) rewrites z = (1, 0, 0), 0, ... of every argument whose zero
// flag it raised (calculate_z's batch inversion: the total's inverse is
// inv(0) = 0), resets both counters and moves the epoch on, so the scratch
// is never reset by the host.
__global__ void __launch_bounds__(GP_LANES, GP_MIN_BLOCKS)
    grand_product_kernel(const __grid_constant__ GpParams p) {
  extern __shared__ uint64_t gp_sh[];
  const int lane = threadIdx.x;
  uint64_t* head = p.scratch;
  unsigned long long ticket = 0;
  if (lane == 0)
    ticket = atomicAdd(reinterpret_cast<unsigned long long*>(head), 1ull);
  ticket = __shfl_sync(FULL, ticket, 0);
  const uint64_t epoch = ld_cg(head + 2);
  const long long tile = static_cast<long long>(ticket) / p.n_args;
  const int a = static_cast<int>(static_cast<long long>(ticket) -
                                 tile * p.n_args);
  const GpArg& g = p.arg[a];
  uint64_t* entries = head + GP_HEAD + a * p.tiles * GP_ENTRY;
  uint64_t* zero = head + 4 + a;
  switch (g.dims) {
    case 5:
      gp_tile<1, 1>(g, p.n, tile, entries, zero, epoch, gp_sh, lane);
      break;
    case 7:
      gp_tile<1, 3>(g, p.n, tile, entries, zero, epoch, gp_sh, lane);
      break;
    case 13:
      gp_tile<3, 1>(g, p.n, tile, entries, zero, epoch, gp_sh, lane);
      break;
    default:
      gp_tile<3, 3>(g, p.n, tile, entries, zero, epoch, gp_sh, lane);
  }
  __syncwarp();
  unsigned long long done = 0;
  if (lane == 0) {
    __threadfence();
    done = atomicAdd(reinterpret_cast<unsigned long long*>(head + 1), 1ull);
  }
  done = __shfl_sync(FULL, done, 0);
  if (done + 1 != static_cast<unsigned long long>(p.tiles * p.n_args)) return;
  __threadfence();
  for (int b = 0; b < p.n_args; ++b) {
    if (ld_cg(head + 4 + b) != epoch + 1) continue;
    const GpArg& h = p.arg[b];
    for (long long e = lane; e < 3 * p.n; e += GP_LANES) {
      const long long r = e / 3;
      h.z[r * h.z_stride + (e - 3 * r)] = e == 0;
    }
  }
  if (lane == 0) {
    st_cg(head, 0);
    st_cg(head + 1, 0);
    st_cg(head + 2, epoch + 1);
  }
}

// Dynamic shared memory of one block for arguments of dims (nd, dd).
int gp_smem(int nd, int dd) { return 8 * GP_LANES * gp_pitch(nd + dd); }

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


// The grand products of n_args arguments of n rows each: `table` a host
// array of 8 int64s an argument (num, its row stride and dim, den, its row
// stride and dim, z, its row stride; strides in u64 words), in launches of
// at most GP_MAX_ARGS arguments; `scratch` GP_HEAD + min(n_args,
// GP_MAX_ARGS) * tiles * GP_ENTRY u64 words, zeroed once when it is
// allocated (the kernel leaves it ready for the next launch). Returns the
// cudaError of the launches.
extern "C" int stark_grand_product(const long long* table, int n_args,
                                   long long n, void* scratch, void* stream) {
  if (n <= 0 || n_args <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int first = 0; first < n_args; first += GP_MAX_ARGS) {
    GpParams p;
    p.n_args = n_args - first < GP_MAX_ARGS ? n_args - first : GP_MAX_ARGS;
    int smem = 0;
    for (int i = 0; i < p.n_args; ++i) {
      const long long* t = table + 8 * (first + i);
      GpArg& g = p.arg[i];
      g.num = reinterpret_cast<const uint64_t*>(t[0]);
      g.num_stride = t[1];
      g.den = reinterpret_cast<const uint64_t*>(t[3]);
      g.den_stride = t[4];
      g.z = reinterpret_cast<uint64_t*>(t[6]);
      g.z_stride = t[7];
      g.dims = static_cast<int>(t[2] * 4 + t[5]);
      g.paired = g.den == g.num + t[2] && g.den_stride == g.num_stride &&
                 t[1] % 2 == 0 && t[0] % 16 == 0;
      const int b = gp_smem(static_cast<int>(t[2]), static_cast<int>(t[5]));
      smem = b > smem ? b : smem;
    }
    p.scratch = static_cast<uint64_t*>(scratch);
    p.n = n;
    p.tiles = (n + GP_LANES * GP_RUN - 1) / (GP_LANES * GP_RUN);
    grand_product_kernel<<<static_cast<unsigned>(p.tiles * p.n_args),
                           GP_LANES, smem, s>>>(p);
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  return 0;
}

// grand_product_kernel's build and launch shape: out[0..7] = rows of a
// tile, threads of a block, registers a thread, local (stack) bytes a
// thread, shared bytes of a GL3 block, GL3 blocks an SM holds, GP_HEAD,
// GP_ENTRY. Returns the cudaError of the queries.
extern "C" int stark_grand_product_plan(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, grand_product_kernel);
  const int smem = gp_smem(3, 3);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, grand_product_kernel, GP_LANES, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int v[8] = {GP_LANES * GP_RUN, GP_LANES, attr.numRegs,
                    static_cast<int>(attr.localSizeBytes), smem, per_sm,
                    GP_HEAD, GP_ENTRY};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}
