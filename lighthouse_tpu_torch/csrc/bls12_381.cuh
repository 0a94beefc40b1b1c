// BLS12-381 device arithmetic for the CUDA kernels (sm_90a).
//
// Fp: 12 little-endian 32-bit limbs, Montgomery form with R = 2^384, every
// value fully reduced (< p) after every op -- the layout of the plain
// PyTorch versions (crypto/bls/cuda/fp.py), so kernel outputs compare limb
// for limb.  Products are CIOS Montgomery multiplication with 32x32->64-bit
// limb products and one conditional final subtraction.
//
// Tower as in crypto/bls/fields_ref.py: Fp2 = Fp[u]/(u^2+1),
// Fp6 = Fp2[v]/(v^3 - xi), xi = 1 + u, Fp12 = Fp6[w]/(w^2 - v).
// Points are Jacobian (X, Y, Z) with infinity Z = 0.
//
// This is the one-thread Fp and Fp2 layer under the kernels' programs: the
// block-cooperative pairing, point engine and checks (pair_coop.cuh,
// points_coop.cuh, check_coop.cuh: the CIOS product here is the pairing's
// product site, fp_ptx.cuh's fmul the others'), the lane machine of
// hash_g2.cuh and xmd.cuh.  The Fp6 / Fp12 tower and the curve operations
// live in those programs, spread over a block's threads, not here.
//
// Without __CUDACC__ the header compiles as plain C++ (the qualifiers
// vanish), which lets a host build check the arithmetic against the
// Python references.
#pragma once
#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#define LH_DEV __device__ __forceinline__
#define LH_NI __device__ __noinline__
#define LH_CONST __constant__ const
#else
#define LH_DEV static inline
#define LH_NI static
#define LH_CONST static const
#endif

#define LH_NL 12

struct fp_t { uint32_t v[LH_NL]; };
struct fp2_t { fp_t c0, c1; };
template <class F> struct jac_t { F x, y, z; };
typedef jac_t<fp2_t> g2_t;

#include "bls12_381_consts.cuh"

// ---------------------------------------------------------------- Fp ------

LH_DEV void set_zero(fp_t& r) {
#pragma unroll
  for (int i = 0; i < LH_NL; i++) r.v[i] = 0;
}
LH_DEV void set_one(fp_t& r) { r = LH_ONE; }
LH_DEV bool is_zero(const fp_t& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < LH_NL; i++) acc |= a.v[i];
  return acc == 0;
}
LH_DEV bool eq(const fp_t& a, const fp_t& b) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < LH_NL; i++) acc |= a.v[i] ^ b.v[i];
  return acc == 0;
}

// r = t - p if t >= p (t given as 12 words plus a top word), else t.
LH_DEV void reduce_once(fp_t& r, const uint32_t* t, uint32_t top) {
  uint32_t d[LH_NL];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < LH_NL; i++) {
    uint64_t x = (uint64_t)t[i] - LH_P.v[i] - borrow;
    d[i] = (uint32_t)x;
    borrow = x >> 63;
  }
  bool ge = (top != 0) | (borrow == 0);     // no short circuit: a select
#pragma unroll
  for (int i = 0; i < LH_NL; i++) r.v[i] = ge ? d[i] : t[i];
}

LH_DEV void add(fp_t& r, const fp_t& a, const fp_t& b) {
  uint32_t t[LH_NL];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < LH_NL; i++) {
    c += (uint64_t)a.v[i] + b.v[i];
    t[i] = (uint32_t)c;
    c >>= 32;
  }
  reduce_once(r, t, (uint32_t)c);
}

LH_DEV void sub(fp_t& r, const fp_t& a, const fp_t& b) {
  uint32_t t[LH_NL];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < LH_NL; i++) {
    uint64_t x = (uint64_t)a.v[i] - b.v[i] - borrow;
    t[i] = (uint32_t)x;
    borrow = x >> 63;
  }
  uint32_t mask = borrow ? 0xffffffffu : 0u;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < LH_NL; i++) {
    c += (uint64_t)t[i] + (LH_P.v[i] & mask);
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
}

LH_DEV void neg(fp_t& r, const fp_t& a) {
  fp_t z;
  set_zero(z);
  sub(r, z, a);
}

// CIOS Montgomery product: r = a b R^-1 mod p, for a b < R p (true when
// a < R and b < p, or both < 2p).  The running value t < R + p needs 13
// words; the product column of each outer step adds a 14th.
LH_DEV void mul(fp_t& r, const fp_t& a, const fp_t& b) {
  uint32_t t[LH_NL + 2];
#pragma unroll
  for (int i = 0; i < LH_NL + 2; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < LH_NL; i++) {
    uint32_t bi = b.v[i];
    uint32_t carry = 0;
#pragma unroll
    for (int j = 0; j < LH_NL; j++) {
      uint64_t s = (uint64_t)a.v[j] * bi + t[j] + carry;
      t[j] = (uint32_t)s;
      carry = (uint32_t)(s >> 32);
    }
    uint64_t s = (uint64_t)t[LH_NL] + carry;
    t[LH_NL] = (uint32_t)s;
    t[LH_NL + 1] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * LH_N0;
    s = (uint64_t)m * LH_P.v[0] + t[0];
    carry = (uint32_t)(s >> 32);
#pragma unroll
    for (int j = 1; j < LH_NL; j++) {
      s = (uint64_t)m * LH_P.v[j] + t[j] + carry;
      t[j - 1] = (uint32_t)s;
      carry = (uint32_t)(s >> 32);
    }
    s = (uint64_t)t[LH_NL] + carry;
    t[LH_NL - 1] = (uint32_t)s;
    t[LH_NL] = t[LH_NL + 1] + (uint32_t)(s >> 32);
  }
  reduce_once(r, t, t[LH_NL]);
}

LH_DEV void sqr(fp_t& r, const fp_t& a) { mul(r, a, a); }

LH_DEV void to_mont(fp_t& r, const fp_t& a) { mul(r, a, LH_R2); }
LH_DEV void from_mont(fp_t& r, const fp_t& a) {
  fp_t one;
  set_zero(one);
  one.v[0] = 1;
  mul(r, a, one);
}

// --------------------------------------------------------------- Fp2 ------

LH_DEV void set_zero(fp2_t& r) { set_zero(r.c0); set_zero(r.c1); }
LH_DEV void set_one(fp2_t& r) { set_one(r.c0); set_zero(r.c1); }
LH_DEV bool is_zero(const fp2_t& a) { return is_zero(a.c0) & is_zero(a.c1); }
LH_DEV bool eq(const fp2_t& a, const fp2_t& b) {
  return eq(a.c0, b.c0) && eq(a.c1, b.c1);
}
LH_DEV void add(fp2_t& r, const fp2_t& a, const fp2_t& b) {
  add(r.c0, a.c0, b.c0);
  add(r.c1, a.c1, b.c1);
}
LH_DEV void sub(fp2_t& r, const fp2_t& a, const fp2_t& b) {
  sub(r.c0, a.c0, b.c0);
  sub(r.c1, a.c1, b.c1);
}
LH_DEV void neg(fp2_t& r, const fp2_t& a) { neg(r.c0, a.c0); neg(r.c1, a.c1); }
LH_DEV void conj(fp2_t& r, const fp2_t& a) { r.c0 = a.c0; neg(r.c1, a.c1); }

// a (1 + u) = (a0 - a1) + (a0 + a1) u
LH_DEV void mul_by_xi(fp2_t& r, const fp2_t& a) {
  fp_t t0, t1;
  sub(t0, a.c0, a.c1);
  add(t1, a.c0, a.c1);
  r.c0 = t0;
  r.c1 = t1;
}

// Karatsuba: 3 Fp products.
LH_NI void mul(fp2_t& r, const fp2_t& a, const fp2_t& b) {
  fp_t t0, t1, sa, sb, t2;
  mul(t0, a.c0, b.c0);
  mul(t1, a.c1, b.c1);
  add(sa, a.c0, a.c1);
  add(sb, b.c0, b.c1);
  mul(t2, sa, sb);
  sub(r.c0, t0, t1);
  sub(t2, t2, t0);
  sub(r.c1, t2, t1);
}

// (a0 + a1)(a0 - a1) + 2 a0 a1 u
LH_NI void sqr(fp2_t& r, const fp2_t& a) {
  fp_t s, d, m;
  add(s, a.c0, a.c1);
  sub(d, a.c0, a.c1);
  mul(m, a.c0, a.c1);
  mul(r.c0, s, d);
  add(r.c1, m, m);
}

// ------------------------------------------------------------ Points ------

template <class F>
LH_DEV void pt_set_inf(jac_t<F>& p) {
  set_zero(p.x);
  set_one(p.y);
  set_zero(p.z);
}

// -------------------------------------------------------------- Sign -----

// a > (p - 1) / 2 for a canonical PLAIN element: the borrow out of
// (p - 1) / 2 - a.
LH_DEV bool gt_half_p(const fp_t& a) {
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < LH_NL; i++) {
    uint64_t x = (uint64_t)LH_HALF_P.v[i] - a.v[i] - borrow;
    borrow = x >> 63;
  }
  return borrow != 0;
}

// ----------------------------------------------- Constant sequence ------
//
// For secret scalars (the signer, hash_g2.cuh): word-wise mask selects in
// place of branches, and a compression with no branch on the point.  The
// Fp layer under them is branch-free too (its conditional subtraction is a
// select), and the exponent of a Fermat inversion is a public constant.

// All ones where b, else 0.
LH_DEV uint32_t mask_of(bool b) { return 0u - (uint32_t)b; }

// r = m ? a : b for an all-ones or zero mask m, word by word.
template <class T>
LH_DEV void ct_select(T& r, const T& a, const T& b, uint32_t m) {
  uint32_t* d = reinterpret_cast<uint32_t*>(&r);
  const uint32_t* x = reinterpret_cast<const uint32_t*>(&a);
  const uint32_t* y = reinterpret_cast<const uint32_t*>(&b);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 4); i++)
    d[i] = (x[i] & m) | (y[i] & ~m);
}

// --------------------------------------------------------- Memory I/O -----

LH_DEV void load(fp_t& r, const uint32_t* p) {
#pragma unroll
  for (int i = 0; i < LH_NL; i++) r.v[i] = p[i];
}
LH_DEV void store(uint32_t* p, const fp_t& a) {
#pragma unroll
  for (int i = 0; i < LH_NL; i++) p[i] = a.v[i];
}
LH_DEV void load(fp2_t& r, const uint32_t* p) { load(r.c0, p); load(r.c1, p + LH_NL); }
LH_DEV void store(uint32_t* p, const fp2_t& a) { store(p, a.c0); store(p + LH_NL, a.c1); }
