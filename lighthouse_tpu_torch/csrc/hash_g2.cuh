// Hash to G2 of the field elements (u0, u1) for one thread: the simplified
// SWU map on the 3-isogenous curve, the isogeny, the sum of both points and
// cofactor clearing.  SSWU runs in affine coordinates with Fermat
// inversions, as crypto/bls/hash_to_curve_ref.py does; square roots use the
// norm trick (two 379-bit Fp powers); cofactor clearing is Budroni-Pintore,
//   [h_eff] P = [x^2 - x - 1] P + [x - 1] psi(P) + psi^2([2] P),
// two 64-bit ladders.  Shared by k_hash (the verify path) and k_sign.
#pragma once
#include "bls12_381.cuh"

// RFC 9380 sgn0 (m = 2) of a canonical plain element.
LH_DEV bool sgn0_plain(const fp2_t& a) {
  bool s0 = a.c0.v[0] & 1;
  bool s1 = a.c1.v[0] & 1;
  return s0 || (is_zero(a.c0) && s1);
}

// g(x) = (x^2 + A) x + B on E2'.
LH_DEV void sswu_rhs(fp2_t& r, const fp2_t& x) {
  fp2_t t;
  sqr(t, x);
  fp2_t a = LH_SSWU_A, b = LH_SSWU_B;
  add(t, t, a);
  mul(t, t, x);
  add(r, t, b);
}

// Plain u -> affine (x, y) Montgomery on E2: simplified SWU + 3-isogeny.
LH_NI void map_to_curve_g2(fp2_t& xo, fp2_t& yo, const fp2_t& u_plain) {
  fp2_t u, t, zu2, tv, x1, x, y, g;
  to_mont(u.c0, u_plain.c0);
  to_mont(u.c1, u_plain.c1);
  sqr(t, u);
  fp2_t z = LH_SSWU_Z;
  mul(zu2, z, t);
  sqr(tv, zu2);
  add(tv, tv, zu2);                  // Z^2 u^4 + Z u^2
  if (is_zero(tv)) {
    x1 = LH_SSWU_EXC_X1;             // B / (Z A)
  } else {
    inv(t, tv);
    fp2_t one;
    set_one(one);
    add(t, t, one);
    fp2_t nba = LH_SSWU_NEG_B_OVER_A;
    mul(x1, nba, t);                 // -B/A (1 + 1/tv)
  }
  sswu_rhs(g, x1);
  if (fp2_sqrt(y, g)) {
    x = x1;
  } else {
    mul(x, zu2, x1);
    sswu_rhs(g, x);
    fp2_sqrt(y, g);
  }
  fp2_t yp;
  from_mont(yp.c0, y.c0);
  from_mont(yp.c1, y.c1);
  if (sgn0_plain(u_plain) != sgn0_plain(yp)) neg(y, y);
  // 3-isogeny: XNUM, XDEN, YNUM, YDEN by Horner.
  fp2_t poly[4];
  for (int p = 0; p < 4; p++) {
    fp2_t acc = LH_ISO[p][3];
    for (int k = 2; k >= 0; k--) {
      mul(acc, acc, x);
      fp2_t c = LH_ISO[p][k];
      add(acc, acc, c);
    }
    poly[p] = acc;
  }
  inv(t, poly[1]);
  mul(xo, poly[0], t);
  inv(t, poly[3]);
  mul(g, y, poly[2]);
  mul(yo, g, t);
}

LH_NI void g2_mul_by_x(g2_t& r, const g2_t& p) {
  pt_mul_u64(r, p, LH_ABS_X);
  pt_neg(r, r);                      // x < 0
}

LH_NI void clear_cofactor(g2_t& r, const g2_t& p) {
  g2_t t1, t2, np, acc, s;
  g2_mul_by_x(t1, p);
  g2_mul_by_x(t2, t1);
  pt_neg(np, p);
  pt_neg(s, t1);
  pt_add(acc, t2, s);
  pt_add(acc, acc, np);              // [x^2 - x - 1] P
  pt_add(s, t1, np);
  g2_psi(s, s);
  pt_add(acc, acc, s);               // + [x - 1] psi(P)
  pt_double(s, p);
  g2_psi(s, s);
  g2_psi(s, s);
  pt_add(r, acc, s);                 // + psi^2([2] P)
}

// u (48 words: u0, u1, canonical plain) -> H(m), Jacobian.
LH_NI void hash_to_g2(g2_t& q, const uint32_t* u) {
  fp2_t u0, u1, x, y;
  load(u0, u);
  load(u1, u + 24);
  g2_t q0, q1;
  map_to_curve_g2(x, y, u0);
  pt_from_affine(q0, x, y, false);
  map_to_curve_g2(x, y, u1);
  pt_from_affine(q1, x, y, false);
  pt_add(q, q0, q1);
  clear_cofactor(q, q);
}
