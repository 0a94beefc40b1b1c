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
// Points are Jacobian (X, Y, Z) with infinity Z = 0; addition is complete by
// case analysis (P == Q doubles, P == -Q gives infinity, infinity passes).
//
// One thread owns one field element at a time: every kernel of this slice
// is one thread per lane (set, message or pair), so the whole tower lives in
// a thread's registers and local memory.  What bounds these kernels on the
// card is the 32-bit integer multiply-add rate: one Fp product is
// 2 * 12 * 12 = 288 IMADs.  The tower functions are __noinline__ to bound
// ptxas time and register pressure.  The pairing, the weighting ladders,
// wire decoding and the subgroup checks run on this arithmetic spread over
// blocks instead (pair_coop.cuh, points_coop.cuh, check_coop.cuh).
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
struct fp6_t { fp2_t c0, c1, c2; };
struct fp12_t { fp6_t c0, c1; };
template <class F> struct jac_t { F x, y, z; };
typedef jac_t<fp_t> g1_t;
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

// a^e for an exponent given as 12 plain words (MSB-first square and
// multiply from the top set bit); a^0 = 1.
LH_NI void fp_pow(fp_t& r, const fp_t& a, const fp_t& e) {
  fp_t acc;
  set_one(acc);
  bool started = false;
  for (int w = LH_NL - 1; w >= 0; w--) {
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

// Fermat inversion a^(p-2); inv(0) = 0.
LH_NI void inv(fp_t& r, const fp_t& a) { fp_pow(r, a, LH_EXP_INV); }

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

LH_DEV void mul_fp(fp2_t& r, const fp2_t& a, const fp_t& s) {
  mul(r.c0, a.c0, s);
  mul(r.c1, a.c1, s);
}

// 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2); inv(0) = 0.
LH_NI void inv(fp2_t& r, const fp2_t& a) {
  fp_t n0, n1, n;
  sqr(n0, a.c0);
  sqr(n1, a.c1);
  add(n, n0, n1);
  inv(n, n);
  mul(r.c0, a.c0, n);
  mul(n1, a.c1, n);
  neg(r.c1, n1);
}

// Square root by the norm trick (the algorithm of the plain version and of
// the TPU package's fp2.sqrt, which return the same root).  Returns whether
// the root squares back to a.
LH_NI bool fp2_sqrt(fp2_t& r, const fp2_t& a) {
  fp_t n, t, s, d1, a1h, td, ts, c, chi, ws, a1h_td, x0, x1;
  sqr(n, a.c0);
  sqr(t, a.c1);
  add(n, n, t);
  fp_pow(t, n, LH_EXP_SQRT);
  mul(s, t, n);                      // sqrt(n) when n is a square
  add(t, a.c0, s);
  mul(d1, t, LH_INV2);               // (a0 + s) / 2
  mul(a1h, a.c1, LH_INV2);           // a1 / 2
  fp_pow(td, d1, LH_EXP_SQRT);
  fp_pow(ts, s, LH_EXP_SQRT);
  mul(c, td, d1);
  mul(chi, c, td);                   // chi(d1) in {0, 1, -1}
  mul(ws, ts, s);                    // sqrt(s), for the corner d1 = 0
  mul(a1h_td, a1h, td);
  bool good = eq(chi, LH_ONE);
  if (good) {
    x0 = c;
    x1 = a1h_td;
  } else {
    x0 = a1h_td;
    neg(x1, c);
  }
  if (is_zero(d1)) {
    set_zero(x0);
    x1 = ws;
  }
  r.c0 = x0;
  r.c1 = x1;
  fp2_t chk;
  sqr(chk, r);
  return eq(chk, a);
}

// --------------------------------------------------------------- Fp6 ------

LH_DEV void set_zero(fp6_t& r) { set_zero(r.c0); set_zero(r.c1); set_zero(r.c2); }
LH_DEV void add(fp6_t& r, const fp6_t& a, const fp6_t& b) {
  add(r.c0, a.c0, b.c0);
  add(r.c1, a.c1, b.c1);
  add(r.c2, a.c2, b.c2);
}
LH_DEV void sub(fp6_t& r, const fp6_t& a, const fp6_t& b) {
  sub(r.c0, a.c0, b.c0);
  sub(r.c1, a.c1, b.c1);
  sub(r.c2, a.c2, b.c2);
}
// (b0 + b1 v + b2 v^2) v = xi b2 + b0 v + b1 v^2
LH_DEV void mul_by_v(fp6_t& r, const fp6_t& a) {
  fp2_t t;
  mul_by_xi(t, a.c2);
  r.c2 = a.c1;
  r.c1 = a.c0;
  r.c0 = t;
}

// Karatsuba-3: 6 Fp2 products.
LH_NI void mul(fp6_t& r, const fp6_t& a, const fp6_t& b) {
  fp2_t t0, t1, t2, s, u, c0, c1, c2;
  mul(t0, a.c0, b.c0);
  mul(t1, a.c1, b.c1);
  mul(t2, a.c2, b.c2);
  add(s, a.c1, a.c2);
  add(u, b.c1, b.c2);
  mul(c0, s, u);
  sub(c0, c0, t1);
  sub(c0, c0, t2);
  mul_by_xi(c0, c0);
  add(c0, c0, t0);                   // xi(u12 - t1 - t2) + t0
  add(s, a.c0, a.c1);
  add(u, b.c0, b.c1);
  mul(c1, s, u);
  sub(c1, c1, t0);
  sub(c1, c1, t1);
  mul_by_xi(s, t2);
  add(c1, c1, s);                    // u01 - t0 - t1 + xi t2
  add(s, a.c0, a.c2);
  add(u, b.c0, b.c2);
  mul(c2, s, u);
  sub(c2, c2, t0);
  sub(c2, c2, t2);
  add(c2, c2, t1);                   // u02 - t0 - t2 + t1
  r.c0 = c0;
  r.c1 = c1;
  r.c2 = c2;
}

// -------------------------------------------------------------- Fp12 ------

// Karatsuba-2 over Fp6: 3 Fp6 products.
LH_NI void mul(fp12_t& r, const fp12_t& a, const fp12_t& b) {
  fp6_t t0, t1, s, u;
  mul(t0, a.c0, b.c0);
  mul(t1, a.c1, b.c1);
  add(s, a.c0, a.c1);
  add(u, b.c0, b.c1);
  mul(s, s, u);
  sub(s, s, t0);
  sub(r.c1, s, t1);
  mul_by_v(t1, t1);
  add(r.c0, t0, t1);
}

// ------------------------------------------------------------ Points ------

template <class F>
LH_DEV bool pt_is_inf(const jac_t<F>& p) { return is_zero(p.z); }

template <class F>
LH_DEV void pt_set_inf(jac_t<F>& p) {
  set_zero(p.x);
  set_one(p.y);
  set_zero(p.z);
}

template <class F>
LH_DEV void pt_from_affine(jac_t<F>& p, const F& x, const F& y, bool inf) {
  p.x = x;
  p.y = y;
  if (inf) set_zero(p.z); else set_one(p.z);
}

template <class F>
LH_DEV void pt_neg(jac_t<F>& r, const jac_t<F>& p) {
  r.x = p.x;
  neg(r.y, p.y);
  r.z = p.z;
}

// dbl-2009-l (a = 0); infinity maps to infinity (Z3 = 2YZ = 0).
template <class F>
LH_NI void pt_double(jac_t<F>& r, const jac_t<F>& p) {
  F A, B, C, D, E, Fq, t, X3, Y3, Z3;
  sqr(A, p.x);
  sqr(B, p.y);
  sqr(C, B);
  add(t, p.x, B);
  sqr(t, t);
  sub(t, t, A);
  sub(t, t, C);
  add(D, t, t);                      // 2((X + B)^2 - A - C)
  add(E, A, A);
  add(E, E, A);                      // 3A
  sqr(Fq, E);
  add(t, D, D);
  sub(X3, Fq, t);
  sub(t, D, X3);
  mul(Y3, E, t);
  add(C, C, C);
  add(C, C, C);
  add(C, C, C);
  sub(Y3, Y3, C);                    // E(D - X3) - 8C
  mul(Z3, p.y, p.z);
  add(Z3, Z3, Z3);
  r.x = X3;
  r.y = Y3;
  r.z = Z3;
}

// add-2007-bl without the case analysis: r is P + Q where P, Q are finite
// and P != +-Q.  h0 and r0 say whether H = U2 - U1 and S2 - S1 are zero
// (P == Q when both are, P == -Q when only H is).
template <class F>
LH_NI void pt_add_generic(jac_t<F>& r, const jac_t<F>& p, const jac_t<F>& q,
                          bool& h0, bool& r0) {
  F Z1Z1, Z2Z2, U1, U2, S1, S2, H, I, J, rr, V, t, X3, Y3, Z3;
  sqr(Z1Z1, p.z);
  sqr(Z2Z2, q.z);
  mul(U1, p.x, Z2Z2);
  mul(U2, q.x, Z1Z1);
  mul(S1, p.y, q.z);
  mul(S1, S1, Z2Z2);
  mul(S2, q.y, p.z);
  mul(S2, S2, Z1Z1);
  sub(H, U2, U1);
  sub(rr, S2, S1);
  h0 = is_zero(H);
  r0 = is_zero(rr);
  add(rr, rr, rr);
  add(I, H, H);
  sqr(I, I);                         // (2H)^2
  mul(J, H, I);
  mul(V, U1, I);
  sqr(X3, rr);
  sub(X3, X3, J);
  sub(X3, X3, V);
  sub(X3, X3, V);                    // r^2 - J - 2V
  sub(t, V, X3);
  mul(Y3, rr, t);
  mul(t, S1, J);
  add(t, t, t);
  sub(Y3, Y3, t);                    // r(V - X3) - 2 S1 J
  add(Z3, p.z, q.z);
  sqr(Z3, Z3);
  sub(Z3, Z3, Z1Z1);
  sub(Z3, Z3, Z2Z2);
  mul(Z3, Z3, H);                    // ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H
  r.x = X3;
  r.y = Y3;
  r.z = Z3;
}

// Complete addition: add-2007-bl with the case analysis.  For public
// points only (its branches follow the data; the signer's ladder settles
// the cases by masks, hash_g2.cuh).
template <class F>
LH_NI void pt_add(jac_t<F>& r, const jac_t<F>& p, const jac_t<F>& q) {
  if (pt_is_inf(p)) { r = q; return; }
  if (pt_is_inf(q)) { r = p; return; }
  jac_t<F> s;
  bool h0, r0;
  pt_add_generic(s, p, q, h0, r0);
  if (h0) {
    if (r0) {
      pt_double(r, p);               // P == Q
    } else {
      pt_set_inf(r);                 // P == -Q
    }
    return;
  }
  r = s;
}

// ------------------------------------------------------ Decompression -----

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

// The ZCash sign of a Montgomery Fp2 element, decided on the real value
// (the Montgomery factor comes off first): c1 > (p - 1) / 2, or c0 when
// c1 == 0.
LH_DEV bool fp2_is_lex_largest(const fp2_t& y) {
  fp_t c0, c1;
  from_mont(c0, y.c0);
  from_mont(c1, y.c1);
  return is_zero(c1) ? gt_half_p(c0) : gt_half_p(c1);
}

// Wire x (canonical plain limbs), sign and infinity flags -> the Jacobian
// point (Z = 1, or 0 at infinity) with y = sqrt(x^3 + 4(1 + u)) of the
// wire's sign.  Returns "x == 0" on an infinity lane and "on the curve"
// elsewhere; a non-square right-hand side returns false.
LH_NI bool g2_decompress(g2_t& pt, const fp2_t& x, bool sign, bool inf) {
  fp2_t xm, rhs, y;
  to_mont(xm.c0, x.c0);
  to_mont(xm.c1, x.c1);
  sqr(rhs, xm);
  mul(rhs, rhs, xm);
  add(rhs, rhs, LH_B2);
  bool on_curve = fp2_sqrt(y, rhs);
  if (fp2_is_lex_largest(y) != sign) neg(y, y);
  pt_from_affine(pt, xm, y, inf);
  return inf ? is_zero(x) : on_curve;
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

// The compressed planes of p: canonical plain affine x, the lexicographic
// sign of y and the infinity flag.  No branch on the point: Fermat's
// 1/Z = Z^(p - 2) is 0 at infinity, so x = y = 0 there (sign 0).
LH_NI void g2_compress(fp2_t& xo, bool& sign, bool& inf, const g2_t& p) {
  fp2_t zi, zi2, zi3, x, y;
  inv(zi, p.z);
  sqr(zi2, zi);
  mul(zi3, zi2, zi);
  mul(x, p.x, zi2);
  mul(y, p.y, zi3);
  from_mont(xo.c0, x.c0);
  from_mont(xo.c1, x.c1);
  fp_t c0, c1;                       // fp2_is_lex_largest, as a select
  from_mont(c0, y.c0);
  from_mont(c1, y.c1);
  bool z = is_zero(c1);
  sign = (z & gt_half_p(c0)) | (!z & gt_half_p(c1));
  inf = pt_is_inf(p);
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

template <class T>
LH_DEV void load_words(T& r, const uint32_t* p) {
  uint32_t* d = reinterpret_cast<uint32_t*>(&r);
  for (int i = 0; i < (int)(sizeof(T) / 4); i++) d[i] = p[i];
}
template <class T>
LH_DEV void store_words(uint32_t* p, const T& a) {
  const uint32_t* s = reinterpret_cast<const uint32_t*>(&a);
  for (int i = 0; i < (int)(sizeof(T) / 4); i++) p[i] = s[i];
}

// Per-thread stack for the deepest __noinline__ chain of the one-thread-a-
// lane kernels (k_ring_mul, k_sign's aggregation).
#define LH_STACK_BYTES 16384

#ifdef __CUDACC__
// An entry point of those kernels sets a per-thread stack large enough for
// their deepest __noinline__ chain and returns cudaGetLastError().
static inline cudaError_t lh_ensure_stack(size_t bytes) {
  size_t cur = 0;
  cudaError_t e = cudaDeviceGetLimit(&cur, cudaLimitStackSize);
  if (e != cudaSuccess) return e;
  if (cur < bytes) return cudaDeviceSetLimit(cudaLimitStackSize, bytes);
  return cudaSuccess;
}
#endif
