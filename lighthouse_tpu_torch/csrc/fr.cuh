// BLS12-381 scalar field Fr for the CUDA kernels (sm_90a).
//
// Fr: 8 little-endian 32-bit limbs, Montgomery form with R = 2^256, every
// value fully reduced (< r) after every op -- the layout of the plain
// PyTorch versions (crypto/kzg/cuda/fr.py), so kernel outputs compare limb
// for limb.  Products are CIOS Montgomery multiplication with 32x32->64-bit
// limb products and one conditional final subtraction: 2 * 8 * 8 = 128
// IMADs a product.  r < 2^255, so a sum of two elements fits 8 words plus a
// carry and a * b < R r holds for any two canonical inputs.
//
// Counterpart of the device side of lighthouse_tpu/crypto/kzg/fr.py, whose
// 13-bit limbs, 2^260 radix and lazy bounds do not carry over.
//
// Without __CUDACC__ the header compiles as plain C++ (the qualifiers
// vanish), which lets a host build check the arithmetic against Python.
#pragma once
#include <stddef.h>
#include <stdint.h>

#ifndef LH_DEV
#ifdef __CUDACC__
#define LH_DEV __device__ __forceinline__
#define LH_NI __device__ __noinline__
#define LH_CONST __constant__ const
#else
#define LH_DEV static inline
#define LH_NI static
#define LH_CONST static const
#endif
#endif

#define FR_NL 8

struct fr_t { uint32_t v[FR_NL]; };

// r (plain), -r^-1 mod 2^32, R mod r, R^2 mod r, r - 2 (plain); a test
// holds these equal to crypto/bls/constants.py.
LH_CONST fr_t FR_MOD = {{0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
                         0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u}};
#define FR_N0 0xffffffffu
LH_CONST fr_t FR_ONE = {{0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau,
                         0xecbc4ff5u, 0x998c4fefu, 0xacc5056fu, 0x1824b159u}};
LH_CONST fr_t FR_R2 = {{0xf3f29c6du, 0xc999e990u, 0x87925c23u, 0x2b6cedcbu,
                        0x7254398fu, 0x05d31496u, 0x9f59ff11u, 0x0748d9d9u}};
LH_CONST fr_t FR_EXP_INV = {{0xffffffffu, 0xfffffffeu, 0xfffe5bfeu,
                             0x53bda402u, 0x09a1d805u, 0x3339d808u,
                             0x299d7d48u, 0x73eda753u}};

LH_DEV void set_zero(fr_t& r) {
#pragma unroll
  for (int i = 0; i < FR_NL; i++) r.v[i] = 0;
}
LH_DEV void set_one(fr_t& r) { r = FR_ONE; }
LH_DEV bool is_zero(const fr_t& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < FR_NL; i++) acc |= a.v[i];
  return acc == 0;
}

LH_DEV void load(fr_t& r, const uint32_t* p) {
#pragma unroll
  for (int i = 0; i < FR_NL; i++) r.v[i] = p[i];
}
LH_DEV void store(uint32_t* p, const fr_t& a) {
#pragma unroll
  for (int i = 0; i < FR_NL; i++) p[i] = a.v[i];
}

// r = t - r_mod if t >= r_mod (t given as 8 words plus a top word), else t.
LH_DEV void reduce_once(fr_t& r, const uint32_t* t, uint32_t top) {
  uint32_t d[FR_NL];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < FR_NL; i++) {
    uint64_t x = (uint64_t)t[i] - FR_MOD.v[i] - borrow;
    d[i] = (uint32_t)x;
    borrow = x >> 63;
  }
  bool ge = (top != 0) | (borrow == 0);     // no short circuit: a select
#pragma unroll
  for (int i = 0; i < FR_NL; i++) r.v[i] = ge ? d[i] : t[i];
}

LH_DEV void add(fr_t& r, const fr_t& a, const fr_t& b) {
  uint32_t t[FR_NL];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < FR_NL; i++) {
    c += (uint64_t)a.v[i] + b.v[i];
    t[i] = (uint32_t)c;
    c >>= 32;
  }
  reduce_once(r, t, (uint32_t)c);
}

LH_DEV void sub(fr_t& r, const fr_t& a, const fr_t& b) {
  uint32_t t[FR_NL];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < FR_NL; i++) {
    uint64_t x = (uint64_t)a.v[i] - b.v[i] - borrow;
    t[i] = (uint32_t)x;
    borrow = x >> 63;
  }
  uint32_t mask = borrow ? 0xffffffffu : 0u;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < FR_NL; i++) {
    c += (uint64_t)t[i] + (FR_MOD.v[i] & mask);
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
}

// CIOS Montgomery product: r = a b R^-1 mod r_mod, for a b < R r_mod (any
// two canonical inputs).  The running value t < R + r_mod needs 9 words;
// the product column of each outer step adds a 10th.
LH_DEV void mul(fr_t& r, const fr_t& a, const fr_t& b) {
  uint32_t t[FR_NL + 2];
#pragma unroll
  for (int i = 0; i < FR_NL + 2; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < FR_NL; i++) {
    uint32_t bi = b.v[i];
    uint32_t carry = 0;
#pragma unroll
    for (int j = 0; j < FR_NL; j++) {
      uint64_t s = (uint64_t)a.v[j] * bi + t[j] + carry;
      t[j] = (uint32_t)s;
      carry = (uint32_t)(s >> 32);
    }
    uint64_t s = (uint64_t)t[FR_NL] + carry;
    t[FR_NL] = (uint32_t)s;
    t[FR_NL + 1] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * FR_N0;
    s = (uint64_t)m * FR_MOD.v[0] + t[0];
    carry = (uint32_t)(s >> 32);
#pragma unroll
    for (int j = 1; j < FR_NL; j++) {
      s = (uint64_t)m * FR_MOD.v[j] + t[j] + carry;
      t[j - 1] = (uint32_t)s;
      carry = (uint32_t)(s >> 32);
    }
    s = (uint64_t)t[FR_NL] + carry;
    t[FR_NL - 1] = (uint32_t)s;
    t[FR_NL] = t[FR_NL + 1] + (uint32_t)(s >> 32);
  }
  reduce_once(r, t, t[FR_NL]);
}

LH_DEV void sqr(fr_t& r, const fr_t& a) { mul(r, a, a); }

// a^e for an exponent given as 8 plain words (MSB-first square and
// multiply from the top set bit); a^0 = 1.
LH_NI void fr_pow(fr_t& r, const fr_t& a, const fr_t& e) {
  fr_t acc;
  set_one(acc);
  bool started = false;
  for (int w = FR_NL - 1; w >= 0; w--) {
    uint32_t word = e.v[w];
    for (int b = 31; b >= 0; b--) {
      if (started) sqr(acc, acc);
      if ((word >> b) & 1) {
        if (started) {
          mul(acc, acc, a);
        } else {
          acc = a;
          started = true;
        }
      }
    }
  }
  r = acc;
}

// Fermat inversion a^(r-2); inv(0) = 0.
LH_NI void inv(fr_t& r, const fr_t& a) { fr_pow(r, a, FR_EXP_INV); }

LH_DEV void to_mont(fr_t& r, const fr_t& a) { mul(r, a, FR_R2); }
LH_DEV void from_mont(fr_t& r, const fr_t& a) {
  fr_t one;
  set_zero(one);
  one.v[0] = 1;
  mul(r, a, one);
}
