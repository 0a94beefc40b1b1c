// The Miller loop of one pair lane, shared by k_pair (the batch product)
// and k_each (per-set verdicts): T in Jacobian coordinates on the twist,
// lines evaluated at affine P (the formulas of tpu/pairing.py
// _doubling_step / _addition_step, scaled by Fp2 factors that the final
// exponentiation kills), over the 63 bits of |x| below the leading one;
// x < 0, so f is conjugated at the end.  A lane with an infinity point
// gives f = 1.
#pragma once
#include "bls12_381.cuh"

LH_NI void doubling_step(fp2_t& a, fp2_t& b, fp2_t& c, g2_t& t,
                         const fp_t& xp, const fp_t& yp) {
  fp2_t X2, Y2, Z2, YZ, X3, X2Z2, YZ3, u;
  sqr(X2, t.x);
  sqr(Y2, t.y);
  sqr(Z2, t.z);
  mul(YZ, t.y, t.z);
  mul(X3, X2, t.x);
  mul(X2Z2, X2, Z2);
  mul(YZ3, YZ, Z2);
  mul_fp(a, YZ3, yp);
  add(a, a, a);                      // 2 Y Z^3 yp
  add(b, X3, X3);
  add(b, b, X3);
  add(u, Y2, Y2);
  sub(b, b, u);                      // 3 X^3 - 2 Y^2
  add(u, X2Z2, X2Z2);
  add(u, u, X2Z2);
  mul_fp(c, u, xp);
  neg(c, c);                         // -3 X^2 Z^2 xp
  pt_double(t, t);
}

LH_NI void addition_step(fp2_t& a, fp2_t& b, fp2_t& c, g2_t& t,
                         const fp2_t& xq, const fp2_t& yq, const fp_t& xp,
                         const fp_t& yp) {
  fp2_t Z2, Z3, xqZ2, yqZ3, N, D, ZD, Nxq, yqZD;
  sqr(Z2, t.z);
  mul(Z3, t.z, Z2);
  mul(xqZ2, xq, Z2);
  mul(yqZ3, yq, Z3);
  sub(N, yqZ3, t.y);
  sub(D, xqZ2, t.x);
  mul(ZD, t.z, D);
  mul(Nxq, N, xq);
  mul(yqZD, yq, ZD);
  sub(b, Nxq, yqZD);                 // N xq - Z D yq
  mul_fp(a, ZD, yp);                 // Z D yp
  mul_fp(c, N, xp);
  neg(c, c);                         // -N xp
  g2_t q;
  pt_from_affine(q, xq, yq, false);
  pt_add(t, t, q);
}

LH_NI void miller_lane(fp12_t& f, const fp_t& xp, const fp_t& yp,
                       const fp2_t& xq, const fp2_t& yq, bool inactive) {
  set_one(f);
  if (inactive) return;
  g2_t t;
  pt_from_affine(t, xq, yq, false);
  fp2_t a, b, c;
  for (int i = 62; i >= 0; i--) {
    mul(f, f, f);
    doubling_step(a, b, c, t, xp, yp);
    mul_by_line(f, a, b, c);
    if ((LH_ABS_X >> i) & 1) {
      addition_step(a, b, c, t, xq, yq, xp, yp);
      mul_by_line(f, a, b, c);
    }
  }
  conj(f, f);
}
