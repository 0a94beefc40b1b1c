// SHA-256 expand_message_xmd of a 32-byte signing root, reduced to the
// hash-to-field elements (u0, u1) of RFC 9380 hash_to_field, for one thread:
// 19 SHA-256 compressions (3 for b0, 2 for each of b1..b8), then each 64-byte
// chunk goes mod p with two Montgomery products (hi 2^384 + lo ->
// hi R^2 + lo R, then out of Montgomery form).  Shared by k_xmd (the verify
// path) and k_sign (k_sign_root).
#pragma once
#include "bls12_381.cuh"

LH_DEV uint32_t rotr(uint32_t x, int r) {
  return (x >> r) | (x << (32 - r));
}

LH_NI void sha256_compress(uint32_t st[8], const uint32_t blk[16]) {
  uint32_t w[64];
  for (int i = 0; i < 16; i++) w[i] = blk[i];
  for (int i = 16; i < 64; i++) {
    uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
    uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
  for (int i = 0; i < 64; i++) {
    uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = h + S1 + ch + LH_SHA_K[i] + w[i];
    uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    uint32_t t2 = S0 + maj;
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// 16 big-endian words of a 64-byte chunk -> its value mod p (plain).
LH_DEV void chunk_mod_p(fp_t& r, const uint32_t wds[16]) {
  fp_t lo, hi, t0, t1;
  for (int i = 0; i < 12; i++) lo.v[i] = wds[15 - i];
  set_zero(hi);
  for (int i = 0; i < 4; i++) hi.v[i] = wds[3 - i];
  mul(t0, lo, LH_R2);                // lo R   (lo < R, R^2 mod p < p)
  mul(t1, hi, LH_R3);                // hi R^2
  add(t0, t0, t1);                   // v R mod p
  from_mont(r, t0);
}

// One message: msg -> out (48 words).
LH_NI void xmd_lane(const uint32_t* msg, uint32_t* out) {
  uint32_t blk[16], st[8], b0[8], prev[8];
  for (int k = 0; k < 8; k++) st[k] = LH_SHA_IV[k];
  for (int k = 0; k < 16; k++) blk[k] = 0;          // Z_pad
  sha256_compress(st, blk);
  for (int k = 0; k < 8; k++) blk[k] = msg[k];
  for (int k = 0; k < 8; k++) blk[8 + k] = LH_XMD_B0_BLK2_TAIL[k];
  sha256_compress(st, blk);
  for (int k = 0; k < 16; k++) blk[k] = LH_XMD_B0_BLK3[k];
  sha256_compress(st, blk);
  for (int k = 0; k < 8; k++) b0[k] = st[k];
  uint32_t uni[16];
  for (int j = 1; j <= 8; j++) {
    for (int k = 0; k < 8; k++) blk[k] = j == 1 ? b0[k] : (b0[k] ^ prev[k]);
    for (int k = 0; k < 8; k++) blk[8 + k] = LH_XMD_BI_BLK1_TAIL[k];
    blk[8] |= (uint32_t)j << 24;
    for (int k = 0; k < 8; k++) st[k] = LH_SHA_IV[k];
    sha256_compress(st, blk);
    for (int k = 0; k < 16; k++) blk[k] = LH_XMD_BI_BLK2[k];
    sha256_compress(st, blk);
    for (int k = 0; k < 8; k++) prev[k] = st[k];
    // b_j fills half a 64-byte chunk: chunks are (b1 b2), (b3 b4), ...
    for (int k = 0; k < 8; k++) uni[8 * ((j - 1) & 1) + k] = st[k];
    if ((j & 1) == 0) {
      fp_t u;
      chunk_mod_p(u, uni);
      store(out + 12 * ((j - 1) >> 1), u);
    }
  }
}
