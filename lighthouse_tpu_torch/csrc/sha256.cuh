// SHA-256 compression (FIPS 180-4) for one thread, shared by the hash
// engine's kernels (k_sha256.cu) and expand_message_xmd (xmd.cuh).
//
// sha256_block is inlined and unrolled: the rounds index the message window
// and the round constants with compile-time indices, so the 16-word window,
// the 8 state words and the constants (operands from the constant bank) all
// stay in registers.  The schedule rolls over a 16-word window instead of
// expanding 64 words.  sha256_block_kw runs the rounds of a constant block
// whose K[i] + W[i] were folded ahead of time (the padding block of a
// 64-byte message, LH_SHA_PAD64_KW): no schedule work at all.
//
// Words are natural values; SSZ bytes reach a kernel as little-endian
// 32-bit loads, so the kernels swap them with sha_bswap (one PRMT) on the
// way in and, for digest bytes, on the way out.
//
// Without __CUDACC__ the header compiles as plain C++, so a host build can
// check the lane functions against hashlib before a chip run.
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define LH_SHA_DEV __device__ __forceinline__
#define LH_SHA_CONST __constant__ const
#else
#define LH_SHA_DEV static inline
#define LH_SHA_CONST static const
#endif

// Round constants (FIPS 180-4 section 4.2.2) and the initial hash value
// (section 5.3.3).
LH_SHA_CONST uint32_t LH_SHA_K[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u,
    0x3956c25bu, 0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u,
    0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u,
    0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
    0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
    0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u,
    0xc6e00bf3u, 0xd5a79147u, 0x06ca6351u, 0x14292967u,
    0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u,
    0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
    0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u,
    0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
    0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u,
    0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu, 0x682e6ff3u,
    0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u,
};
LH_SHA_CONST uint32_t LH_SHA_IV[8] = {
    0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
    0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u,
};
// K[i] + W[i] of the padding block of a 64-byte message (0x80, zeros, bit
// length 512): PAD64_KW of the JAX kernel (crypto/sha256/kernel.py:98).
LH_SHA_CONST uint32_t LH_SHA_PAD64_KW[64] = {
    0xc28a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u,
    0x3956c25bu, 0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u,
    0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf374u,
    0x649b69c1u, 0xf0fe4786u, 0x0fe1edc6u, 0x240cf254u,
    0x4fe9346fu, 0x6cc984beu, 0x61b9411eu, 0x16f988fau,
    0xf2c65152u, 0xa88e5a6du, 0xb019fc65u, 0xb9d99ec7u,
    0x9a1231c3u, 0xe70eeaa0u, 0xfdb1232bu, 0xc7353eb0u,
    0x3069bad5u, 0xcb976d5fu, 0x5a0f118fu, 0xdc1eeefdu,
    0x0a35b689u, 0xde0b7a04u, 0x58f4ca9du, 0xe15d5b16u,
    0x007f3e86u, 0x37088980u, 0xa507ea32u, 0x6fab9537u,
    0x17406110u, 0x0d8cd6f1u, 0xcdaa3b6du, 0xc0bbbe37u,
    0x83613bdau, 0xdb48a363u, 0x0b02e931u, 0x6fd15ca7u,
    0x521afacau, 0x31338431u, 0x6ed41a95u, 0x6d437890u,
    0xc39c91f2u, 0x9eccabbdu, 0xb5c9a0e6u, 0x532fb63cu,
    0xd2c741c6u, 0x07237ea3u, 0xa4954b68u, 0x4c191d76u,
};

LH_SHA_DEV uint32_t sha_rotr(uint32_t x, int r) {
  return (x >> r) | (x << (32 - r));
}

LH_SHA_DEV uint32_t sha_bswap(uint32_t x) {
#ifdef __CUDACC__
  return __byte_perm(x, 0, 0x0123);
#else
  return __builtin_bswap32(x);
#endif
}

// One round: the state rotates through the names, so an unrolled loop
// renames registers instead of moving them.
#define LH_SHA_ROUND(a, b, c, d, e, f, g, h, kw)                            \
  do {                                                                      \
    uint32_t t1_ = h + (sha_rotr(e, 6) ^ sha_rotr(e, 11) ^ sha_rotr(e, 25)) \
                   + ((e & f) ^ (~e & g)) + (kw);                           \
    uint32_t t2_ = (sha_rotr(a, 2) ^ sha_rotr(a, 13) ^ sha_rotr(a, 22))     \
                   + ((a & b) ^ (a & c) ^ (b & c));                         \
    d += t1_;                                                               \
    h = t1_ + t2_;                                                          \
  } while (0)

#define LH_SHA_8ROUNDS(i, KW)                          \
  LH_SHA_ROUND(a, b, c, d, e, f, g, h, KW(i + 0));     \
  LH_SHA_ROUND(h, a, b, c, d, e, f, g, KW(i + 1));     \
  LH_SHA_ROUND(g, h, a, b, c, d, e, f, KW(i + 2));     \
  LH_SHA_ROUND(f, g, h, a, b, c, d, e, KW(i + 3));     \
  LH_SHA_ROUND(e, f, g, h, a, b, c, d, KW(i + 4));     \
  LH_SHA_ROUND(d, e, f, g, h, a, b, c, KW(i + 5));     \
  LH_SHA_ROUND(c, d, e, f, g, h, a, b, KW(i + 6));     \
  LH_SHA_ROUND(b, c, d, e, f, g, h, a, KW(i + 7))

// W[i] of round i from the rolling window (i >= 16 extends it in place).
LH_SHA_DEV uint32_t sha_sched(uint32_t w[16], int i) {
  if (i < 16) return w[i];
  uint32_t w15 = w[(i - 15) & 15], w2 = w[(i - 2) & 15];
  uint32_t s0 = sha_rotr(w15, 7) ^ sha_rotr(w15, 18) ^ (w15 >> 3);
  uint32_t s1 = sha_rotr(w2, 17) ^ sha_rotr(w2, 19) ^ (w2 >> 10);
  w[i & 15] += s0 + w[(i - 7) & 15] + s1;
  return w[i & 15];
}

// st <- compress(st, blk): 16 message words (natural values).
LH_SHA_DEV void sha256_block(uint32_t st[8], const uint32_t blk[16]) {
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 16; i++) w[i] = blk[i];
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#define LH_SHA_KW_VAR(i) (LH_SHA_K[i] + sha_sched(w, i))
#pragma unroll
  for (int i = 0; i < 64; i += 8) {
    LH_SHA_8ROUNDS(i, LH_SHA_KW_VAR);
  }
#undef LH_SHA_KW_VAR
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// st <- compress(st, the block whose K[i] + W[i] are kw[i]).
LH_SHA_DEV void sha256_block_kw(uint32_t st[8], const uint32_t* kw) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#define LH_SHA_KW_CONST(i) (kw[i])
#pragma unroll
  for (int i = 0; i < 64; i += 8) {
    LH_SHA_8ROUNDS(i, LH_SHA_KW_CONST);
  }
#undef LH_SHA_KW_CONST
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}
