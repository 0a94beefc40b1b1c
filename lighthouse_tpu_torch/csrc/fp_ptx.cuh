// The Fp product and squaring on PTX carry chains, and the variable-time
// binary-Euclid inverse, for the lane machine of hash_g2.cuh (k_hash,
// k_sign_root, k_sign_field) and the cooperative pairing (pair_coop.cuh).
//
// fmul is CIOS Montgomery multiplication (R = 2^384) written as the card's
// multiply-add carry chains: a row a * b_i adds its 12 limb products as two
// interleaved column chains, one over the even limbs of a into accumulator
// E and one over the odd limbs into O (O weighs one word more), so each
// chain is a run of mad.lo.cc / madc.hi.cc with no two products landing on
// one word; the reduction adds m p the same way, and the division by 2^32
// swaps the roles of E and O (the old O becomes the new E, plus one word of
// the old E; the old E, shifted two words, is folded into the next row's
// odd chain).  The running value stays below 2p because a, b < p; every
// output is fully reduced (< p) by one branch-free conditional subtraction,
// so the words are the CIOS product's (bls12_381.cuh mul) for every input
// below p.  fsqr squares by separated operand scanning: the 66 products
// a_i a_j, i < j, once, doubled, plus the diagonal, then a Montgomery
// reduction of the 768-bit square that folds each division by 2^32 into
// the next reduction row's odd chain.
//
// On the card every chain is PTX (mad.lo.cc.u32, madc.hi.cc.u32, ...).
// Without __CUDA_ARCH__ the same chains run as plain C with the carry flag
// in a variable, so a host build of the lane machine executes the same
// sequence of word operations.
#pragma once
#include "bls12_381.cuh"

#if defined(__CUDA_ARCH__)
#define LH_PTX 1
#else
#define LH_PTX 0
#endif

// The carry flag of the host emulation (unused on the card, where the
// flag is the hardware's).
struct lh_cf { uint32_t c; };

LH_DEV uint32_t c_mul_lo(uint32_t a, uint32_t b) { return a * b; }
LH_DEV uint32_t c_mul_hi(uint32_t a, uint32_t b) {
#if LH_PTX
  return __umulhi(a, b);
#else
  return (uint32_t)(((uint64_t)a * b) >> 32);
#endif
}

#if LH_PTX
#define LH_ASM1(op, d, a, b, c)                                            \
  asm volatile(op " %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c))
#define LH_ASM0(op, d, a, b)                                               \
  asm volatile(op " %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b))
#endif

// lo(a b) + c -> carry out
LH_DEV uint32_t mad_lo_cc(lh_cf& f, uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
#if LH_PTX
  (void)f;
  LH_ASM1("mad.lo.cc.u32", d, a, b, c);
#else
  uint64_t s = (uint64_t)(a * b) + c;
  d = (uint32_t)s;
  f.c = (uint32_t)(s >> 32);
#endif
  return d;
}
// lo(a b) + c + carry -> carry out
LH_DEV uint32_t madc_lo_cc(lh_cf& f, uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
#if LH_PTX
  (void)f;
  LH_ASM1("madc.lo.cc.u32", d, a, b, c);
#else
  uint64_t s = (uint64_t)(a * b) + c + f.c;
  d = (uint32_t)s;
  f.c = (uint32_t)(s >> 32);
#endif
  return d;
}
// hi(a b) + c + carry -> carry out
LH_DEV uint32_t madc_hi_cc(lh_cf& f, uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
#if LH_PTX
  (void)f;
  LH_ASM1("madc.hi.cc.u32", d, a, b, c);
#else
  uint64_t s = (uint64_t)c_mul_hi(a, b) + c + f.c;
  d = (uint32_t)s;
  f.c = (uint32_t)(s >> 32);
#endif
  return d;
}
// hi(a b) + c + carry, no carry out (the caller knows it is 0)
LH_DEV uint32_t madc_hi(lh_cf& f, uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
#if LH_PTX
  (void)f;
  LH_ASM1("madc.hi.u32", d, a, b, c);
#else
  d = (uint32_t)((uint64_t)c_mul_hi(a, b) + c + f.c);
#endif
  return d;
}
LH_DEV uint32_t add_cc(lh_cf& f, uint32_t a, uint32_t b) {
  uint32_t d;
#if LH_PTX
  (void)f;
  LH_ASM0("add.cc.u32", d, a, b);
#else
  uint64_t s = (uint64_t)a + b;
  d = (uint32_t)s;
  f.c = (uint32_t)(s >> 32);
#endif
  return d;
}
LH_DEV uint32_t addc_cc(lh_cf& f, uint32_t a, uint32_t b) {
  uint32_t d;
#if LH_PTX
  (void)f;
  LH_ASM0("addc.cc.u32", d, a, b);
#else
  uint64_t s = (uint64_t)a + b + f.c;
  d = (uint32_t)s;
  f.c = (uint32_t)(s >> 32);
#endif
  return d;
}
LH_DEV uint32_t addc(lh_cf& f, uint32_t a, uint32_t b) {
  uint32_t d;
#if LH_PTX
  (void)f;
  LH_ASM0("addc.u32", d, a, b);
#else
  d = a + b + f.c;
#endif
  return d;
}
LH_DEV uint32_t sub_cc(lh_cf& f, uint32_t a, uint32_t b) {
  uint32_t d;
#if LH_PTX
  (void)f;
  LH_ASM0("sub.cc.u32", d, a, b);
#else
  uint64_t s = (uint64_t)a - b;
  d = (uint32_t)s;
  f.c = (uint32_t)(s >> 63);
#endif
  return d;
}
LH_DEV uint32_t subc_cc(lh_cf& f, uint32_t a, uint32_t b) {
  uint32_t d;
#if LH_PTX
  (void)f;
  LH_ASM0("subc.cc.u32", d, a, b);
#else
  uint64_t s = (uint64_t)a - b - f.c;
  d = (uint32_t)s;
  f.c = (uint32_t)(s >> 63);
#endif
  return d;
}
LH_DEV uint32_t subc(lh_cf& f, uint32_t a, uint32_t b) {
  uint32_t d;
#if LH_PTX
  (void)f;
  LH_ASM0("subc.u32", d, a, b);
#else
  d = a - b - f.c;
#endif
  return d;
}

// r = t - p if t >= p, else t, for t < 2p: the borrow of t - p selects,
// word by word.
LH_DEV void fp_final_sub(fp_t& r, const uint32_t* t) {
  lh_cf f{0};
  uint32_t d[LH_NL];
  d[0] = sub_cc(f, t[0], LH_P.v[0]);
#pragma unroll
  for (int i = 1; i < LH_NL; i++) d[i] = subc_cc(f, t[i], LH_P.v[i]);
  const uint32_t keep = subc(f, 0u, 0u);     // all ones where t < p
#pragma unroll
  for (int i = 0; i < LH_NL; i++) r.v[i] = (t[i] & keep) | (d[i] & ~keep);
}

// E, O = a * bi, the first row: even limbs of a into E, odd into O.
LH_DEV void fm_first(uint32_t* E, uint32_t* O, const uint32_t* a,
                     uint32_t bi) {
#pragma unroll
  for (int j = 0; j < LH_NL; j += 2) {
    E[j] = c_mul_lo(a[j], bi);
    E[j + 1] = c_mul_hi(a[j], bi);
    O[j] = c_mul_lo(a[j + 1], bi);
    O[j + 1] = c_mul_hi(a[j + 1], bi);
  }
}

// (E, O) += m p with m = E[0] (-p^-1): afterwards E[0] == 0 and the value
// E + 2^32 O is divisible by 2^32.  E's carry out weighs 2^384, O[11]'s.
LH_DEV void fm_reduce(uint32_t* E, uint32_t* O) {
  lh_cf f{0};
  const uint32_t m = E[0] * LH_N0;
  O[0] = mad_lo_cc(f, LH_P.v[1], m, O[0]);
  O[1] = madc_hi_cc(f, LH_P.v[1], m, O[1]);
#pragma unroll
  for (int j = 2; j < LH_NL - 2; j += 2) {
    O[j] = madc_lo_cc(f, LH_P.v[j + 1], m, O[j]);
    O[j + 1] = madc_hi_cc(f, LH_P.v[j + 1], m, O[j + 1]);
  }
  O[LH_NL - 2] = madc_lo_cc(f, LH_P.v[LH_NL - 1], m, O[LH_NL - 2]);
  O[LH_NL - 1] = madc_hi(f, LH_P.v[LH_NL - 1], m, O[LH_NL - 1]);
  E[0] = mad_lo_cc(f, LH_P.v[0], m, E[0]);
  E[1] = madc_hi_cc(f, LH_P.v[0], m, E[1]);
#pragma unroll
  for (int j = 2; j < LH_NL; j += 2) {
    E[j] = madc_lo_cc(f, LH_P.v[j], m, E[j]);
    E[j + 1] = madc_hi_cc(f, LH_P.v[j], m, E[j + 1]);
  }
  O[LH_NL - 1] = addc(f, O[LH_NL - 1], 0u);
}

// One later row: the value (E + 2^32 O) / 2^32 + a bi, written back with
// the roles swapped: O (with E[1] added to its word 0) is the new E, and E
// (the old E shifted two words, plus the odd products) the new O.
LH_DEV void fm_row(uint32_t* E, uint32_t* O, const uint32_t* a,
                   uint32_t bi) {
  lh_cf f{0};
  O[0] = add_cc(f, O[0], E[1]);
#pragma unroll
  for (int j = 0; j < LH_NL - 2; j += 2) {
    E[j] = madc_lo_cc(f, a[j + 1], bi, E[j + 2]);
    E[j + 1] = madc_hi_cc(f, a[j + 1], bi, E[j + 3]);
  }
  E[LH_NL - 2] = madc_lo_cc(f, a[LH_NL - 1], bi, 0u);
  E[LH_NL - 1] = madc_hi(f, a[LH_NL - 1], bi, 0u);
  O[0] = mad_lo_cc(f, a[0], bi, O[0]);
  O[1] = madc_hi_cc(f, a[0], bi, O[1]);
#pragma unroll
  for (int j = 2; j < LH_NL; j += 2) {
    O[j] = madc_lo_cc(f, a[j], bi, O[j]);
    O[j + 1] = madc_hi_cc(f, a[j], bi, O[j + 1]);
  }
  E[LH_NL - 1] = addc(f, E[LH_NL - 1], 0u);
}

// r = (E + 2^32 O) / 2^32 with E[0] == 0, then below p.
LH_DEV void fm_merge(fp_t& r, const uint32_t* E, const uint32_t* O) {
  lh_cf f{0};
  uint32_t t[LH_NL];
  t[0] = add_cc(f, O[0], E[1]);
#pragma unroll
  for (int i = 1; i < LH_NL - 1; i++) t[i] = addc_cc(f, O[i], E[i + 1]);
  t[LH_NL - 1] = addc(f, O[LH_NL - 1], 0u);
  fp_final_sub(r, t);
}

// r = a b R^-1 mod p for a, b < p.
LH_DEV void fmul(fp_t& r, const fp_t& a, const fp_t& b) {
  uint32_t X[LH_NL], Y[LH_NL];
  fm_first(X, Y, a.v, b.v[0]);
  fm_reduce(X, Y);
#pragma unroll
  for (int i = 1; i < LH_NL; i++) {
    if (i & 1) {
      fm_row(X, Y, a.v, b.v[i]);     // now E = Y, O = X
      fm_reduce(Y, X);
    } else {
      fm_row(Y, X, a.v, b.v[i]);     // now E = X, O = Y
      fm_reduce(X, Y);
    }
  }
  fm_merge(r, Y, X);                 // 11 rows after the first: E = Y
}

// The reduction of fsqr: one row with no product, m = E[0] (-p^-1).  On
// entry (E + 2^32 O) / 2^32 is the running value (E[0] == 0 after the last
// row); the row folds the division into its odd chain as fm_row does.
LH_DEV void fr_row(uint32_t* E, uint32_t* O) {
  lh_cf f{0};
  O[0] = add_cc(f, O[0], E[1]);
  const uint32_t m = O[0] * LH_N0;   // the new E[0]; mul.lo keeps the flag
#pragma unroll
  for (int j = 0; j < LH_NL - 2; j += 2) {
    E[j] = madc_lo_cc(f, LH_P.v[j + 1], m, E[j + 2]);
    E[j + 1] = madc_hi_cc(f, LH_P.v[j + 1], m, E[j + 3]);
  }
  E[LH_NL - 2] = madc_lo_cc(f, LH_P.v[LH_NL - 1], m, 0u);
  E[LH_NL - 1] = madc_hi(f, LH_P.v[LH_NL - 1], m, 0u);
  O[0] = mad_lo_cc(f, LH_P.v[0], m, O[0]);
  O[1] = madc_hi_cc(f, LH_P.v[0], m, O[1]);
#pragma unroll
  for (int j = 2; j < LH_NL; j += 2) {
    O[j] = madc_lo_cc(f, LH_P.v[j], m, O[j]);
    O[j + 1] = madc_hi_cc(f, LH_P.v[j], m, O[j + 1]);
  }
  E[LH_NL - 1] = addc(f, E[LH_NL - 1], 0u);
}

// r = a^2 R^-1 mod p for a < p.
LH_DEV void fsqr(fp_t& r, const fp_t& a) {
  uint32_t E[2 * LH_NL], O[2 * LH_NL];
#pragma unroll
  for (int k = 0; k < 2 * LH_NL; k++) E[k] = O[k] = 0;
  // The products a_i a_j, i < j, at word i + j: row i's even offsets
  // (j - i - 1 even) into E, its odd ones into O.  Each chain's carry lands
  // on a word that holds at most an earlier row's carry.
#pragma unroll
  for (int i = 0; i < LH_NL - 1; i++) {
    const int len = LH_NL - 1 - i;
    lh_cf f{0};
    int top = 0;
#pragma unroll
    for (int k = 0; k < len; k += 2) {
      const int pos = 2 * i + 1 + k;
      E[pos] = k == 0 ? mad_lo_cc(f, a.v[i + 1 + k], a.v[i], E[pos])
                      : madc_lo_cc(f, a.v[i + 1 + k], a.v[i], E[pos]);
      E[pos + 1] = madc_hi_cc(f, a.v[i + 1 + k], a.v[i], E[pos + 1]);
      top = pos + 2;
    }
    E[top] = addc(f, E[top], 0u);
    if (len > 1) {
#pragma unroll
      for (int k = 1; k < len; k += 2) {
        const int pos = 2 * i + 1 + k;
        O[pos] = k == 1 ? mad_lo_cc(f, a.v[i + 1 + k], a.v[i], O[pos])
                        : madc_lo_cc(f, a.v[i + 1 + k], a.v[i], O[pos]);
        O[pos + 1] = madc_hi_cc(f, a.v[i + 1 + k], a.v[i], O[pos + 1]);
        top = pos + 2;
      }
      O[top] = addc(f, O[top], 0u);
    }
  }
  // S = 2 (E + O) + the diagonal a_i^2 at word 2i: E[0] = O[0] = O[1] = 0.
  {
    lh_cf f{0};
    E[1] = add_cc(f, E[1], O[1]);
#pragma unroll
    for (int k = 2; k < 2 * LH_NL - 1; k++) E[k] = addc_cc(f, E[k], O[k]);
    E[2 * LH_NL - 1] = addc(f, E[2 * LH_NL - 1], O[2 * LH_NL - 1]);
  }
#pragma unroll
  for (int k = 2 * LH_NL - 1; k > 0; k--) E[k] = (E[k] << 1) | (E[k - 1] >> 31);
  E[0] = 0;
  {
    lh_cf f{0};
    E[0] = mad_lo_cc(f, a.v[0], a.v[0], E[0]);
    E[1] = madc_hi_cc(f, a.v[0], a.v[0], E[1]);
#pragma unroll
    for (int i = 1; i < LH_NL - 1; i++) {
      E[2 * i] = madc_lo_cc(f, a.v[i], a.v[i], E[2 * i]);
      E[2 * i + 1] = madc_hi_cc(f, a.v[i], a.v[i], E[2 * i + 1]);
    }
    E[2 * LH_NL - 2] = madc_lo_cc(f, a.v[LH_NL - 1], a.v[LH_NL - 1],
                                  E[2 * LH_NL - 2]);
    E[2 * LH_NL - 1] = madc_hi(f, a.v[LH_NL - 1], a.v[LH_NL - 1],
                               E[2 * LH_NL - 1]);
  }
  // Montgomery reduction of the low half (E[0..11], O = 0), then the high
  // half E[12..23] added: (lo + M p) / R <= p and hi < p, so below 2p.
  uint32_t X[LH_NL], Y[LH_NL];
#pragma unroll
  for (int k = 0; k < LH_NL; k++) {
    X[k] = E[k];
    Y[k] = 0;
  }
  {
    lh_cf f{0};
    const uint32_t m = X[0] * LH_N0;
#pragma unroll
    for (int j = 0; j < LH_NL; j += 2) {
      Y[j] = c_mul_lo(LH_P.v[j + 1], m);
      Y[j + 1] = c_mul_hi(LH_P.v[j + 1], m);
    }
    X[0] = mad_lo_cc(f, LH_P.v[0], m, X[0]);
    X[1] = madc_hi_cc(f, LH_P.v[0], m, X[1]);
#pragma unroll
    for (int j = 2; j < LH_NL; j += 2) {
      X[j] = madc_lo_cc(f, LH_P.v[j], m, X[j]);
      X[j + 1] = madc_hi_cc(f, LH_P.v[j], m, X[j + 1]);
    }
    Y[LH_NL - 1] = addc(f, Y[LH_NL - 1], 0u);
  }
#pragma unroll
  for (int i = 1; i < LH_NL; i++) {
    if (i & 1) {
      fr_row(X, Y);                  // now E = Y, O = X
    } else {
      fr_row(Y, X);                  // now E = X, O = Y
    }
  }
  // E = Y, O = X: the value is X + Y[1..]; then the high half.
  lh_cf f{0};
  uint32_t t[LH_NL];
  t[0] = add_cc(f, X[0], Y[1]);
#pragma unroll
  for (int i = 1; i < LH_NL - 1; i++) t[i] = addc_cc(f, X[i], Y[i + 1]);
  t[LH_NL - 1] = addc(f, X[LH_NL - 1], 0u);
  t[0] = add_cc(f, t[0], E[LH_NL]);
#pragma unroll
  for (int i = 1; i < LH_NL - 1; i++) t[i] = addc_cc(f, t[i], E[LH_NL + i]);
  t[LH_NL - 1] = addc(f, t[LH_NL - 1], E[2 * LH_NL - 1]);
  fp_final_sub(r, t);
}

// ------------------------------------------- variable-time Fp inverse -----

LH_DEV bool is_one_plain(const fp_t& a) {
  uint32_t acc = a.v[0] ^ 1u;
#pragma unroll
  for (int i = 1; i < LH_NL; i++) acc |= a.v[i];
  return acc == 0;
}

LH_DEV void shr1(fp_t& a) {
#pragma unroll
  for (int i = 0; i < LH_NL - 1; i++)
    a.v[i] = (a.v[i] >> 1) | (a.v[i + 1] << 31);
  a.v[LH_NL - 1] >>= 1;
}

// a >= b on plain words; r = a - b for a >= b.
LH_DEV bool geq_plain(const fp_t& a, const fp_t& b) {
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < LH_NL; i++) {
    uint64_t x = (uint64_t)a.v[i] - b.v[i] - borrow;
    borrow = x >> 63;
  }
  return borrow == 0;
}
LH_DEV void sub_plain(fp_t& r, const fp_t& a, const fp_t& b) {
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < LH_NL; i++) {
    uint64_t x = (uint64_t)a.v[i] - b.v[i] - borrow;
    r.v[i] = (uint32_t)x;
    borrow = x >> 63;
  }
}

// x / 2 mod p for x < p: (x + p) / 2 when x is odd (x + p < 2^382).
LH_DEV void half_mod(fp_t& x) {
  if (x.v[0] & 1) {
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < LH_NL; i++) {
      c += (uint64_t)x.v[i] + LH_P.v[i];
      x.v[i] = (uint32_t)c;
      c >>= 32;
    }
  }
  shr1(x);
}

// 1/a for a Montgomery element by the binary extended Euclidean algorithm
// (variable time: its inputs are public data of a verification).  On the
// words of a = A R it finds y = a^-1 mod p, then A^-1 R = y R^2 = mont(y,
// R^3).  The inverse is unique, so this equals Fermat's a^(p - 2) (the
// plain version's fp.inv); inv(0) = 0 as there.
LH_DEV void fp_inv_vt(fp_t& r, const fp_t& a) {
  if (is_zero(a)) {
    set_zero(r);
    return;
  }
  fp_t u = a, v = LH_P, x1, x2;
  set_zero(x1);
  x1.v[0] = 1;
  set_zero(x2);
  // x1 a == u and x2 a == v (mod p) throughout.
  while (!is_one_plain(u) && !is_one_plain(v)) {
    while (!(u.v[0] & 1)) {
      shr1(u);
      half_mod(x1);
    }
    while (!(v.v[0] & 1)) {
      shr1(v);
      half_mod(x2);
    }
    if (geq_plain(u, v)) {
      sub_plain(u, u, v);
      sub(x1, x1, x2);
    } else {
      sub_plain(v, v, u);
      sub(x2, x2, x1);
    }
  }
  bool one = is_one_plain(u);        // a word select: no local array
  fp_t y;
#pragma unroll
  for (int i = 0; i < LH_NL; i++) y.v[i] = one ? x1.v[i] : x2.v[i];
  mul(r, y, LH_R3);
}
