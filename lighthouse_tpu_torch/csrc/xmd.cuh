// SHA-256 expand_message_xmd of a 32-byte signing root, reduced to the
// hash-to-field elements (u0, u1) of RFC 9380 hash_to_field, for one thread:
// 19 SHA-256 compressions (3 for b0, 2 for each of b1..b8), then each 64-byte
// chunk goes mod p with two Montgomery products (hi 2^384 + lo ->
// hi R^2 + lo R, then out of Montgomery form).  Shared by k_xmd (the verify
// path) and k_sign (k_sign_root).
#pragma once
#include "bls12_381.cuh"
#include "sha256.cuh"

// The compression stays a call (LH_NI) here: xmd_lane makes 19 of them, and
// one unrolled body bounds the code size of k_xmd and k_sign.
LH_NI void sha256_compress(uint32_t st[8], const uint32_t blk[16]) {
  sha256_block(st, blk);
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
