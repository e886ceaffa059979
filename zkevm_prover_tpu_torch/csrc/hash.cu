// Keccak-f[1600], the SHA-256 compression and the Blake2b compression over
// a batch of instances (sm_90a), one library with a plain C interface
// (ops/hash_cuda.py binds it with ctypes).
//
// Replaces three device programs of the JAX package that XLA fuses on the
// TPU (none is a pallas_call):
//  - zkevm_prover_tpu/ops/keccak.py keccak_f: a lax.fori_loop over the 24
//    rounds on (..., 25) u64 lanes, lane index x + 5y (FIPS-202 order);
//  - zkevm_prover_tpu/ops/sha256.py sha256_compress: the message schedule
//    and 64 rounds on (..., 8) u32 states and (..., 16) u32 big-endian
//    message words, plus the feed-forward addition of the input state;
//  - zkevm_prover_tpu/ops/blake.py blake2b_compress: 12 rounds of 8 G
//    quarter-rounds on the SIGMA schedule over (..., 8) u64 states,
//    (..., 16) u64 message words, a (...) byte counter and a (...)
//    last-block flag, then h ^ v[0:8] ^ v[8:16].
// Each is bit-identical to its plain torch twin (keccak.keccak_f_plain,
// sha256.sha256_compress_plain, blake.blake2b_compress_plain). Words
// travel as int64 tensors: a Keccak lane's or a Blake2b word's u64 bit
// pattern, a SHA-256 word zero-extended (the kernel reads the low 32 bits
// and writes them back zero-extended); Blake2b's flag as a bool tensor.
//
// Design: one thread per instance, its whole state in registers (Keccak 25
// u64 lanes as 50 32-bit halves; SHA-256 the 8 state words and a rolling
// 16-word window of the schedule; Blake2b the 16-word working vector and
// the 16 message words, each 64-bit word a pair of 32-bit registers). A
// block of 128 threads copies its
// instances between device memory and a shared-memory tile with
// consecutive threads on consecutive words (coalesced), and each thread
// reads its own row of the tile (the SHA-256 tiles' rows padded to an odd
// number of words against bank conflicts: the SHA-256 and Blake2b tiles).
//  - Keccak: 64-bit rotations as two funnel shifts (SHF), theta's five-way
//    parity, its D application and chi each one LOP3 per 32-bit half: 180
//    32-bit operations per round, 4,320 per permutation. The rounds run in
//    a rolled loop over one unrolled round body (round constants from
//    constant memory).
//  - SHA-256: rotations as one funnel shift, Ch and Maj one LOP3 each, the
//    Sigma and sigma sums one LOP3 each; the 64 rounds fully unrolled.
//  - Blake2b: rotations by 32 a swap of the halves (no instruction), by 24
//    and 16 one byte permute (PRMT) per half, by 63 one funnel shift per
//    half; XORs one LOP3 per half; the 64-bit sums add-with-carry pairs
//    (IADD3 and IADD3.X, three operands each). The 12 rounds are unrolled
//    at compile time, each a template on its round number whose SIGMA row
//    is a compile-time constant: every message word is then a register
//    named by a constant. A SIGMA table in constant memory would index the
//    message words at run time, which puts them in local memory.
//
// What bounds them on the H100: 32-bit integer issue (LOP3, SHF, PRMT,
// IADD3). A Keccak-f permutation is 4,320 such operations against 400
// bytes of device memory, a SHA-256 compression 1,384 against 256 bytes, a
// Blake2b compression 2,134 against 265 bytes (chip_smoke.keccak_bound /
// sha256_bound / blake2b_bound).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 128;
constexpr int LANES = 25;         // Keccak-f state, u64 lanes
constexpr int SHA_STATE = 8;      // SHA-256 state words
constexpr int SHA_WORDS = 16;     // SHA-256 message words per block
// shared tile rows padded to an odd word count
constexpr int SHA_STATE_ROW = SHA_STATE + 1;
constexpr int SHA_WORDS_ROW = SHA_WORDS + 1;
constexpr int B2_STATE = 8;       // Blake2b state words
constexpr int B2_WORDS = 16;      // Blake2b message words per block
constexpr int B2_STATE_ROW = B2_STATE + 1;
constexpr int B2_WORDS_ROW = B2_WORDS + 1;

__constant__ uint64_t KECCAK_RC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
    0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};

__constant__ uint32_t SHA_K[64] = {
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2};

__constant__ uint64_t BLAKE2B_IV[B2_STATE] = {
    0x6A09E667F3BCC908ull, 0xBB67AE8584CAA73Bull, 0x3C6EF372FE94F82Bull,
    0xA54FF53A5F1D36F1ull, 0x510E527FADE682D1ull, 0x9B05688C2B3E6C1Full,
    0x1F83D9ABFB41BD6Bull, 0x5BE0CD19137E2179ull};

// LOP3 truth tables on the operand tables a = 0xF0, b = 0xCC, c = 0xAA
constexpr int LUT_XOR3 = 0x96;   // a ^ b ^ c
constexpr int LUT_CHI = 0xD2;    // a ^ (~b & c)
constexpr int LUT_CH = 0xCA;     // (a & b) ^ (~a & c)
constexpr int LUT_MAJ = 0xE8;    // (a & b) ^ (a & c) ^ (b & c)

template <int LUT>
__device__ __forceinline__ uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, %4;" : "=r"(d) : "r"(a), "r"(b), "r"(c),
      "n"(LUT));
  return d;
}

__device__ __forceinline__ uint32_t lo32(uint64_t v) {
  return static_cast<uint32_t>(v);
}

__device__ __forceinline__ uint32_t hi32(uint64_t v) {
  return static_cast<uint32_t>(v >> 32);
}

__device__ __forceinline__ uint64_t join(uint32_t lo, uint32_t hi) {
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

template <int LUT>
__device__ __forceinline__ uint64_t lop3_64(uint64_t a, uint64_t b,
                                            uint64_t c) {
  return join(lop3<LUT>(lo32(a), lo32(b), lo32(c)),
              lop3<LUT>(hi32(a), hi32(b), hi32(c)));
}

// rotate left by R (1..63, not 32): two funnel shifts on the halves
template <int R>
__device__ __forceinline__ uint64_t rotl64(uint64_t v) {
  static_assert(0 < R && R < 64 && R != 32, "rotation amount");
  const uint32_t lo = lo32(v), hi = hi32(v);
  if constexpr (R < 32) {
    return join(__funnelshift_l(hi, lo, R), __funnelshift_l(lo, hi, R));
  } else {
    return join(__funnelshift_l(lo, hi, R - 32),
                __funnelshift_l(hi, lo, R - 32));
  }
}

// instances of the block starting at `base`: THREADS, or fewer in the last
__device__ __forceinline__ int block_count(int64_t n, int64_t base) {
  return n - base < THREADS ? static_cast<int>(n - base) : THREADS;
}

__device__ __forceinline__ void keccak_permute(uint64_t (&a)[LANES]) {
#pragma unroll 1
  for (int round = 0; round < 24; ++round) {
    // theta: column parities, then a[x + 5y] ^= c[x - 1] ^ rotl(c[x + 1], 1)
    uint64_t c[5];
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      c[x] = lop3_64<LUT_XOR3>(lop3_64<LUT_XOR3>(a[x], a[x + 5], a[x + 10]),
                               a[x + 15], a[x + 20]);
    }
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      const uint64_t r = rotl64<1>(c[(x + 1) % 5]);
      const uint64_t l = c[(x + 4) % 5];
#pragma unroll
      for (int y = 0; y < 5; ++y) {
        a[x + 5 * y] = lop3_64<LUT_XOR3>(a[x + 5 * y], l, r);
      }
    }
    // rho and pi: b[y + 5((2x + 3y) % 5)] = rotl(a[x + 5y], ROT[x + 5y])
    uint64_t b[LANES];
    b[0] = a[0];
    b[16] = rotl64<36>(a[5]);
    b[7] = rotl64<3>(a[10]);
    b[23] = rotl64<41>(a[15]);
    b[14] = rotl64<18>(a[20]);
    b[10] = rotl64<1>(a[1]);
    b[1] = rotl64<44>(a[6]);
    b[17] = rotl64<10>(a[11]);
    b[8] = rotl64<45>(a[16]);
    b[24] = rotl64<2>(a[21]);
    b[20] = rotl64<62>(a[2]);
    b[11] = rotl64<6>(a[7]);
    b[2] = rotl64<43>(a[12]);
    b[18] = rotl64<15>(a[17]);
    b[9] = rotl64<61>(a[22]);
    b[5] = rotl64<28>(a[3]);
    b[21] = rotl64<55>(a[8]);
    b[12] = rotl64<25>(a[13]);
    b[3] = rotl64<21>(a[18]);
    b[19] = rotl64<56>(a[23]);
    b[15] = rotl64<27>(a[4]);
    b[6] = rotl64<20>(a[9]);
    b[22] = rotl64<39>(a[14]);
    b[13] = rotl64<8>(a[19]);
    b[4] = rotl64<14>(a[24]);
    // chi: a[x + 5y] = b[x + 5y] ^ (~b[x + 1 + 5y] & b[x + 2 + 5y])
#pragma unroll
    for (int y = 0; y < 5; ++y) {
#pragma unroll
      for (int x = 0; x < 5; ++x) {
        a[x + 5 * y] = lop3_64<LUT_CHI>(b[x + 5 * y], b[(x + 1) % 5 + 5 * y],
                                        b[(x + 2) % 5 + 5 * y]);
      }
    }
    // iota
    a[0] ^= KECCAK_RC[round];
  }
}

__global__ void __launch_bounds__(THREADS)
keccak_f_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                int64_t n) {
  __shared__ uint64_t tile[THREADS * LANES];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * THREADS;
  const int count = block_count(n, base);
  const uint64_t* src = in + base * LANES;
  for (int i = threadIdx.x; i < count * LANES; i += THREADS) tile[i] = src[i];
  __syncthreads();
  if (threadIdx.x < count) {
    uint64_t a[LANES];
#pragma unroll
    for (int k = 0; k < LANES; ++k) a[k] = tile[threadIdx.x * LANES + k];
    keccak_permute(a);
#pragma unroll
    for (int k = 0; k < LANES; ++k) tile[threadIdx.x * LANES + k] = a[k];
  }
  __syncthreads();
  uint64_t* dst = out + base * LANES;
  for (int i = threadIdx.x; i < count * LANES; i += THREADS) dst[i] = tile[i];
}

__device__ __forceinline__ uint32_t rotr32(uint32_t v, int r) {
  return __funnelshift_r(v, v, r);
}

__global__ void __launch_bounds__(THREADS)
sha256_compress_kernel(const uint64_t* __restrict__ state,
                       const uint64_t* __restrict__ words,
                       uint64_t* __restrict__ out, int64_t n) {
  __shared__ uint32_t st_tile[THREADS * SHA_STATE_ROW];
  __shared__ uint32_t w_tile[THREADS * SHA_WORDS_ROW];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * THREADS;
  const int count = block_count(n, base);
  const uint64_t* st_src = state + base * SHA_STATE;
  const uint64_t* w_src = words + base * SHA_WORDS;
  for (int i = threadIdx.x; i < count * SHA_STATE; i += THREADS) {
    st_tile[i / SHA_STATE * SHA_STATE_ROW + i % SHA_STATE] =
        static_cast<uint32_t>(st_src[i]);
  }
  for (int i = threadIdx.x; i < count * SHA_WORDS; i += THREADS) {
    w_tile[i / SHA_WORDS * SHA_WORDS_ROW + i % SHA_WORDS] =
        static_cast<uint32_t>(w_src[i]);
  }
  __syncthreads();
  if (threadIdx.x < count) {
    uint32_t s0[SHA_STATE], w[SHA_WORDS];
#pragma unroll
    for (int k = 0; k < SHA_STATE; ++k) {
      s0[k] = st_tile[threadIdx.x * SHA_STATE_ROW + k];
    }
#pragma unroll
    for (int k = 0; k < SHA_WORDS; ++k) {
      w[k] = w_tile[threadIdx.x * SHA_WORDS_ROW + k];
    }
    uint32_t a = s0[0], b = s0[1], c = s0[2], d = s0[3];
    uint32_t e = s0[4], f = s0[5], g = s0[6], h = s0[7];
#pragma unroll
    for (int t = 0; t < 64; ++t) {
      uint32_t wt;
      if (t < 16) {
        wt = w[t];
      } else {
        // w[t] = w[t-16] + sigma0(w[t-15]) + w[t-7] + sigma1(w[t-2])
        const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
        const uint32_t sig0 = lop3<LUT_XOR3>(rotr32(w15, 7), rotr32(w15, 18),
                                             w15 >> 3);
        const uint32_t sig1 = lop3<LUT_XOR3>(rotr32(w2, 17), rotr32(w2, 19),
                                             w2 >> 10);
        wt = w[t & 15] + sig0 + w[(t - 7) & 15] + sig1;
        w[t & 15] = wt;
      }
      const uint32_t big1 = lop3<LUT_XOR3>(rotr32(e, 6), rotr32(e, 11),
                                           rotr32(e, 25));
      const uint32_t t1 = h + big1 + lop3<LUT_CH>(e, f, g) + SHA_K[t] + wt;
      const uint32_t big0 = lop3<LUT_XOR3>(rotr32(a, 2), rotr32(a, 13),
                                           rotr32(a, 22));
      const uint32_t t2 = big0 + lop3<LUT_MAJ>(a, b, c);
      h = g;
      g = f;
      f = e;
      e = d + t1;
      d = c;
      c = b;
      b = a;
      a = t1 + t2;
    }
    const uint32_t res[SHA_STATE] = {a, b, c, d, e, f, g, h};
#pragma unroll
    for (int k = 0; k < SHA_STATE; ++k) {
      st_tile[threadIdx.x * SHA_STATE_ROW + k] = s0[k] + res[k];
    }
  }
  __syncthreads();
  uint64_t* dst = out + base * SHA_STATE;
  for (int i = threadIdx.x; i < count * SHA_STATE; i += THREADS) {
    dst[i] = st_tile[i / SHA_STATE * SHA_STATE_ROW + i % SHA_STATE];
  }
}

// Blake2b's SIGMA row r (0..9): message slot i of the round in nibble i
__host__ __device__ constexpr uint64_t blake2b_sigma(int r) {
  return r == 0   ? 0xFEDCBA9876543210ull
         : r == 1 ? 0x357B20C16DF984AEull
         : r == 2 ? 0x491763EADF250C8Bull
         : r == 3 ? 0x8F04A562EBCD1397ull
         : r == 4 ? 0xD386CB1EFA427509ull
         : r == 5 ? 0x91EF57D438B0A6C2ull
         : r == 6 ? 0xB8293670A4DEF15Cull
         : r == 7 ? 0xA2684F05931CE7BDull
         : r == 8 ? 0x5A417D2C803B9EF6ull
                  : 0x0DC3E9BF5167482Aull;
}

__device__ __forceinline__ uint64_t swap_halves(uint64_t v) {
  return join(hi32(v), lo32(v));
}

// rotate right by a whole number of bytes: one PRMT per half, each picking
// its four bytes of the word (bytes 0-3 the low half, 4-7 the high)
template <unsigned LO_BYTES, unsigned HI_BYTES>
__device__ __forceinline__ uint64_t byte_rotr64(uint64_t v) {
  const uint32_t lo = lo32(v), hi = hi32(v);
  return join(__byte_perm(lo, hi, LO_BYTES), __byte_perm(lo, hi, HI_BYTES));
}

template <int A, int B, int C, int D>
__device__ __forceinline__ void blake2b_g(uint64_t (&v)[16], uint64_t x,
                                          uint64_t y) {
  v[A] = v[A] + v[B] + x;
  v[D] = swap_halves(v[D] ^ v[A]);              // rotr 32
  v[C] = v[C] + v[D];
  v[B] = byte_rotr64<0x6543, 0x2107>(v[B] ^ v[C]);  // rotr 24
  v[A] = v[A] + v[B] + y;
  v[D] = byte_rotr64<0x5432, 0x1076>(v[D] ^ v[A]);  // rotr 16
  v[C] = v[C] + v[D];
  v[B] = rotl64<1>(v[B] ^ v[C]);                // rotr 63
}

template <int R>
__device__ __forceinline__ void blake2b_round(uint64_t (&v)[16],
                                              const uint64_t (&m)[16]) {
  constexpr uint64_t s = blake2b_sigma(R % 10);
  blake2b_g<0, 4, 8, 12>(v, m[s & 15], m[(s >> 4) & 15]);
  blake2b_g<1, 5, 9, 13>(v, m[(s >> 8) & 15], m[(s >> 12) & 15]);
  blake2b_g<2, 6, 10, 14>(v, m[(s >> 16) & 15], m[(s >> 20) & 15]);
  blake2b_g<3, 7, 11, 15>(v, m[(s >> 24) & 15], m[(s >> 28) & 15]);
  blake2b_g<0, 5, 10, 15>(v, m[(s >> 32) & 15], m[(s >> 36) & 15]);
  blake2b_g<1, 6, 11, 12>(v, m[(s >> 40) & 15], m[(s >> 44) & 15]);
  blake2b_g<2, 7, 8, 13>(v, m[(s >> 48) & 15], m[(s >> 52) & 15]);
  blake2b_g<3, 4, 9, 14>(v, m[(s >> 56) & 15], m[(s >> 60) & 15]);
}

__global__ void __launch_bounds__(THREADS)
blake2b_compress_kernel(const uint64_t* __restrict__ state,
                        const uint64_t* __restrict__ words,
                        const uint64_t* __restrict__ counter,
                        const uint8_t* __restrict__ last,
                        uint64_t* __restrict__ out, int64_t n) {
  __shared__ uint64_t st_tile[THREADS * B2_STATE_ROW];
  __shared__ uint64_t w_tile[THREADS * B2_WORDS_ROW];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * THREADS;
  const int count = block_count(n, base);
  const uint64_t* st_src = state + base * B2_STATE;
  const uint64_t* w_src = words + base * B2_WORDS;
  for (int i = threadIdx.x; i < count * B2_STATE; i += THREADS) {
    st_tile[i / B2_STATE * B2_STATE_ROW + i % B2_STATE] = st_src[i];
  }
  for (int i = threadIdx.x; i < count * B2_WORDS; i += THREADS) {
    w_tile[i / B2_WORDS * B2_WORDS_ROW + i % B2_WORDS] = w_src[i];
  }
  __syncthreads();
  if (threadIdx.x < count) {
    uint64_t h[B2_STATE], m[B2_WORDS], v[16];
#pragma unroll
    for (int k = 0; k < B2_STATE; ++k) {
      h[k] = st_tile[threadIdx.x * B2_STATE_ROW + k];
      v[k] = h[k];
      v[k + B2_STATE] = BLAKE2B_IV[k];
    }
#pragma unroll
    for (int k = 0; k < B2_WORDS; ++k) {
      m[k] = w_tile[threadIdx.x * B2_WORDS_ROW + k];
    }
    const int64_t i = base + threadIdx.x;
    v[12] ^= counter[i];
    v[14] ^= 0ull - static_cast<uint64_t>(last[i] != 0);
    blake2b_round<0>(v, m);
    blake2b_round<1>(v, m);
    blake2b_round<2>(v, m);
    blake2b_round<3>(v, m);
    blake2b_round<4>(v, m);
    blake2b_round<5>(v, m);
    blake2b_round<6>(v, m);
    blake2b_round<7>(v, m);
    blake2b_round<8>(v, m);
    blake2b_round<9>(v, m);
    blake2b_round<10>(v, m);
    blake2b_round<11>(v, m);
#pragma unroll
    for (int k = 0; k < B2_STATE; ++k) {
      st_tile[threadIdx.x * B2_STATE_ROW + k] =
          lop3_64<LUT_XOR3>(h[k], v[k], v[k + B2_STATE]);
    }
  }
  __syncthreads();
  uint64_t* dst = out + base * B2_STATE;
  for (int i = threadIdx.x; i < count * B2_STATE; i += THREADS) {
    dst[i] = st_tile[i / B2_STATE * B2_STATE_ROW + i % B2_STATE];
  }
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + THREADS - 1) / THREADS);
}

}  // namespace

// (n, 25) u64 lanes in, the permuted lanes out; returns the cudaError of
// the launch (0 when it was accepted).
extern "C" int hash_keccak_f(const void* in, void* out, long long n,
                             void* stream) {
  if (n <= 0) return 0;
  keccak_f_kernel<<<blocks_for(n), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// (n, 8) state words and (n, 16) message words in (each a u32 in an int64),
// the (n, 8) compressed states out; returns the cudaError of the launch.
extern "C" int hash_sha256_compress(const void* state, const void* words,
                                    void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  sha256_compress_kernel<<<blocks_for(n), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(state), static_cast<const uint64_t*>(words),
      static_cast<uint64_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// (n, 8) state words, (n, 16) message words and (n,) byte counters (u64 bit
// patterns in int64s) and (n,) last-block flags (bool bytes) in, the (n, 8)
// compressed states out; returns the cudaError of the launch.
extern "C" int hash_blake2b_compress(const void* state, const void* words,
                                     const void* counter, const void* last,
                                     void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  blake2b_compress_kernel<<<blocks_for(n), THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(state), static_cast<const uint64_t*>(words),
      static_cast<const uint64_t*>(counter),
      static_cast<const uint8_t*>(last), static_cast<uint64_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
