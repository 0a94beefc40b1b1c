// Wire-signature decoding, G1 key decoding and the subgroup checks spread
// over a block of threads, on the point engine of points_coop.cuh:
// k_decode.cu (ck_prog in mode CK_DEC, a block over L wire lanes), and in
// k_verify.cu k_subgroup (CK_SUB, a block over G1 lanes i..i + L and G2
// lanes i..i + L) and k_decode_g1 (CK_DEC1, a block over L compressed G1
// keys); k_sign.cu's k_sign_agg runs the G2 decoding's steps (ck_dec_pow1,
// ck_dec_pow2, ck_dec_root) in a program of its own, with no check.  They
// compute what the plain versions of crypto/bls/cuda/staged.py
// k_decode_plain, k_subgroup_plain and k_decode_g1_plain compute: the
// decoded point is the plain square root (fp2.sqrt, or a^((p + 1) / 4) in
// Fp), word for word, and a check is a verdict.
//
// Design.  A lane is a "job" of pc_engine's rounds (state in shared
// memory, products through lh_block's fmul site, sums a coordinate a task,
// flags read after a barrier): every job runs the same ladder, the bits of
// the public |z|, so the jobs of a block share every round, and the G1
// lanes of k_subgroup run as Fp2 values with c1 = 0 beside the G2 lanes.
//   G2 (both kernels): psi(Q) == -[|z|] Q: 63 doublings and 5 complete
//     additions from acc = Q, then a compare of the affine psi(Q) with the
//     Jacobian accumulator (Z^2, Z^3, psi_x Z^2, psi_y Z^3: 3 product
//     rounds and 1 sum round).
//   G1 (k_subgroup): phi(P) == [lambda] P with lambda = |z|^2 - 1, as
//     phi(P) == [|z|]([|z|] P) - P: the first pass is the G2 jobs' ladder,
//     a second pass runs on the G1 jobs alone from acc = [|z|] P, one
//     complete addition of -P, and the compare with phi(P) = (beta x, y).
//     That is 126 doublings and 11 additions against the 127 doublings and
//     47 additions of the 128-bit lambda ladder; on every point of the
//     curve it gives the same verdict, since it is scalar arithmetic in the
//     group (a point of order 3 reaches P == -Q in the last addition).
//   Decoding (k_decode): x to Montgomery form, x^3 + 4(1 + u), the norm
//     n = a0^2 + a1^2 and t = n^((p - 3) / 4) in one thread a lane; then
//     d1^e and s^e in two threads of one warp, which run in lock step
//     (the same exponent), so the corner d1 == 0's power costs no time;
//     the root, its check and the sign in one thread.  A power is a chain
//     of fsqr and fmul over sliding windows of up to CK_WIN bits, its odd
//     powers in shared memory (ck_pow).
//   G1 decoding (k_decode_g1): one round, one thread a lane: x to
//     Montgomery form, x^3 + 4, y = (x^3 + 4)^((p + 1) / 4) by ck_pow, the
//     check y^2 == x^3 + 4 and the sign on the real value of y; with the
//     check on, the lanes that decoded to a point of the curve then run
//     the G1 program above as the block's jobs (no G2 job).
// Control flow depends on the public |z|, the lanes' flags and values
// read from shared memory after a barrier, so it is uniform over the block
// and every thread reaches every barrier; nothing needs a stack.
//
// Without __CUDACC__ the header compiles as plain C++ and lh_host_group
// runs each round's tasks one after another (forward, or backward), which
// emulates a block for a host harness.
#pragma once
#include <type_traits>

#include "points_coop.cuh"

#define CK_WIN 5                         // window bits of ck_pow
#define CK_TAB (1 << (CK_WIN - 1))       // its odd powers

LH_DEV int ck_bit(const fp_t& e, int i) {
  return (e.v[i >> 5] >> (i & 31)) & 1;
}

// r = a^e for a public e > 0 (12 plain words): left-to-right sliding
// windows of up to W bits, one thread's chain of fsqr and fmul; tab holds
// a, a^3, ..., a^(2^W - 1).  Any chain gives the same canonical words.
template <int W = CK_WIN>
LH_DEV void ck_pow(fp_t& r, const fp_t& a, const fp_t& e, fp_t* tab) {
  fp_t acc;
  fsqr(acc, a);
  tab[0] = a;
  for (int k = 1; k < (1 << (W - 1)); k++) fmul(tab[k], tab[k - 1], acc);
  int i = 32 * LH_NL - 1;
  while (!ck_bit(e, i)) i--;
  bool started = false;
  while (i >= 0) {
    int j = i, v = 0;
    if (ck_bit(e, i)) {                  // the window [j, i], bit j set
      j = i - W + 1 < 0 ? 0 : i - W + 1;
      while (!ck_bit(e, j)) j++;
      for (int b = i; b >= j; b--) v = 2 * v + ck_bit(e, b);
    }
    if (started) {
      for (int b = i; b >= j; b--) fsqr(acc, acc);
      if (v) fmul(acc, acc, tab[v >> 1]);
    } else {
      acc = tab[v >> 1];                 // the top window
      started = true;
    }
    i = j - 1;
  }
  r = acc;
}

#ifdef __CUDACC__
// The multiprocessors of the current device: the launches run a block a
// lane while at most per_sm such blocks fall to an SM, and wide blocks
// beyond (PERF.md, the k_decode / k_subgroup layouts).
static inline cudaError_t ck_narrow(int m, int per_sm, bool& narrow) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  narrow = (long long)m <= (long long)per_sm * sms;
  return e;
}
#endif

// Karatsuba on fmul, for one thread's Fp2 products.
LH_DEV void ck_f2mul(fp2_t& r, const fp2_t& a, const fp2_t& b) {
  fp_t t0, t1, t2, sa, sb;
  fmul(t0, a.c0, b.c0);
  fmul(t1, a.c1, b.c1);
  add(sa, a.c0, a.c1);
  add(sb, b.c0, b.c1);
  fmul(t2, sa, sb);
  sub(r.c0, t0, t1);
  sub(t2, t2, t0);
  sub(r.c1, t2, t1);
}

// k_decode_g1's values of one lane.
struct ck_dec1 {
  fp_t rhs;                              // x^3 + 4
  fp_t tab[CK_TAB];
};

// The values of one lane's G2 decoding (k_decode; k_sign_agg with
// windows of W bits).
template <int W>
struct ck_dec_t {
  fp2_t rhs;                             // x^3 + 4(1 + u)
  fp_t d1, a1h, s, t[2];                 // (a0 + s) / 2, a1 / 2, sqrt(n);
                                         // t: n^e, then d1^e and s^e
  fp_t tab[2][1 << (W - 1)];
  int inf, sign, xz;                     // the wire flags, x == 0
};
using ck_dec = ck_dec_t<CK_WIN>;

// The G2 decoding's steps, e = (p - 3) / 4 (the algorithm and values of
// the plain fp2.sqrt).  Step 1 (K_POW1): x (plain words) to Montgomery
// form xo, the right-hand side x^3 + 4(1 + u), its norm n = a0^2 + a1^2,
// t = n^e, s = t n (sqrt(n) when n is a square), d1 = (a0 + s) / 2 and
// a1 / 2.
template <int W>
LH_DEV void ck_dec_pow1(ck_dec_t<W>& d, fp2_t& xo, const fp2_t& x) {
  fp2_t xm, x2;
  fmul(xm.c0, x.c0, LH_R2);
  fmul(xm.c1, x.c1, LH_R2);
  xo = xm;
  ck_f2mul(x2, xm, xm);
  ck_f2mul(d.rhs, x2, xm);
  add(d.rhs, d.rhs, LH_B2);
  fp_t n, t;
  fsqr(n, d.rhs.c0);
  fsqr(t, d.rhs.c1);
  add(n, n, t);
  ck_pow<W>(t, n, LH_EXP_SQRT, d.tab[0]);
  fmul(d.s, t, n);                       // sqrt(n) when n is a square
  add(t, d.rhs.c0, d.s);
  fmul(d.d1, t, LH_INV2);
  fmul(d.a1h, d.rhs.c1, LH_INV2);
}

// Step 2 (K_POW2, two threads a lane): h = 0 d1^e, h = 1 s^e.
template <int W>
LH_DEV void ck_dec_pow2(ck_dec_t<W>& d, int h) {
  ck_pow<W>(d.t[h], h ? d.s : d.d1, LH_EXP_SQRT, d.tab[h]);
}

// Step 3 (K_ROOT): the root by chi(d1), with the wire's sign on its real
// value, into y (whether or not the right-hand side is a square: the plain
// version's candidate); returns whether y^2 is the right-hand side.
template <int W>
LH_DEV bool ck_dec_root(fp2_t& y, const ck_dec_t<W>& d) {
  // Word selects, not branches over references: a select of two local
  // values' addresses would put them on a stack.
  fp_t c, chi, ws, a1h_td, nc;
  fmul(c, d.t[0], d.d1);
  fmul(chi, c, d.t[0]);                  // chi(d1) in {0, 1, -1}
  fmul(ws, d.t[1], d.s);                 // sqrt(s), for the corner d1 = 0
  fmul(a1h_td, d.a1h, d.t[0]);
  neg(nc, c);
  const bool good = eq(chi, LH_ONE), corner = is_zero(d.d1);
  fp2_t chk;
#pragma unroll
  for (int w = 0; w < LH_NL; w++) {
    y.c0.v[w] = corner ? 0u : (good ? c.v[w] : a1h_td.v[w]);
    y.c1.v[w] = corner ? ws.v[w] : (good ? a1h_td.v[w] : nc.v[w]);
  }
  ck_f2mul(chk, y, y);
  const bool on_curve = eq(chk, d.rhs);
  fp_t one, c0, c1;                      // the sign on the real value
  set_zero(one);
  one.v[0] = 1;
  fmul(c0, y.c0, one);
  fmul(c1, y.c1, one);
  const bool z1 = is_zero(c1);
#pragma unroll
  for (int w = 0; w < LH_NL; w++) c0.v[w] = z1 ? c0.v[w] : c1.v[w];
  fp2_t ny;
  neg(ny, y);
  const bool flip = gt_half_p(c0) != (d.sign != 0);
#pragma unroll
  for (int w = 0; w < LH_NL; w++) {
    y.c0.v[w] = flip ? ny.c0.v[w] : y.c0.v[w];
    y.c1.v[w] = flip ? ny.c1.v[w] : y.c1.v[w];
  }
  return on_curve;
}

// The state of a block over J jobs, DL of them decoded (D: ck_dec, or
// ck_dec1 for G1 keys).
template <int J, int DL, class D = ck_dec>
struct ck_state {
  pc_state<J> pc;                        // acc p[j], operand p[J + j]
  fp2_t bx[J], by[J];                    // job j's point (affine)
  int on[J], eq[J];                      // job j runs; its compare
  D d[DL];
};

// Program rounds.
enum {
  K_POW1 = PC_PROG, K_POW2, K_ROOT, K_DEC1, K_LOAD, K_COPY, K_NEGP, K_C1,
  K_C2, K_C3, K_CMP, K_OUT
};
enum { PH_G2, PH_G1, PH_SUB };           // the ladder passes, then -P
enum { CK_SUB, CK_DEC, CK_DEC1 };        // ck_prog's modes

// One block of k_subgroup (CK_SUB, 2L jobs: G1 lanes in jobs [0, L), G2
// lanes in [L, 2L)), of k_decode (CK_DEC, L jobs) or of k_decode_g1
// (CK_DEC1, L jobs, all G1).
//   k_subgroup in: x1, y1 (12), inf1, act1 over n1 lanes; x2, y2 (24),
//     inf2, act2 over n2; out lanes (n1 + n2) and ok.  A lane absent,
//     inactive or infinity passes.
//   k_decode in: x (12 plain words a coordinate), sign, inf from lane l0,
//     m lanes in all; out xs, ys (24 words), si, and ok cleared by a lane
//     off the curve, outside G2 or a malformed infinity.
//   k_decode_g1 in: x (12 plain words), sign, inf from lane l0, m lanes
//     in all, and check; out xs, ys (12 words), si and each lane's verdict
//     in lanes: "x == 0" on an infinity lane, else on the curve and, with
//     check, in G1.
template <int L, int MODE>
struct ck_prog {
  static constexpr bool DEC = MODE == CK_DEC, DEC1 = MODE == CK_DEC1;
  static constexpr int J = MODE == CK_SUB ? 2 * L : L;
  static constexpr int DL = MODE == CK_SUB ? 1 : L;
  using state_t = ck_state<J, DL, std::conditional_t<DEC1, ck_dec1, ck_dec>>;
  state_t& s;
  pc_engine<J> e;
  int l0;
  const uint32_t *x1, *y1;               // decoders: x1 = the wire x
  const uint8_t *inf1, *act1;            // decoders: inf1 = inf, act1 = sign
  int n1;                                // decoders: m
  const uint32_t *x2, *y2;
  const uint8_t *inf2, *act2;
  int n2;
  uint32_t *xs, *ys;                     // the decoders' points
  uint8_t *si, *lanes, *ok;              // k_decode_g1: lanes = its ok
  int bit, phase;
  bool check;                            // k_decode_g1: the G1 check

  LH_MEM bool g1(int j) { return DEC1 || (MODE == CK_SUB && j < L); }

  LH_MEM int first() {
    e.nj = J;
    e.off = J;
    e.fb = false;
    return DEC ? K_POW1 : (DEC1 ? K_DEC1 : K_LOAD);
  }

  LH_MEM bool any(int from, int to) {
    bool a = false;
    for (int j = from; j < to; j++) a = a || s.on[j];
    return a;
  }

  LH_MEM int ladder(int ph) {
    phase = ph;
    bit = 63;                            // the top bit of |z|
    return step();
  }

  LH_MEM int compare() {
    e.nj = J;
    return K_C1;
  }

  LH_MEM int step() {
    if (phase == PH_SUB) return compare();
    if (bit > 0) {
      bit--;
      return e.start(E_D1);
    }
    if (phase == PH_G2 && !DEC && any(0, L)) {
      e.nj = L;                          // the G1 jobs' second pass
      phase = PH_G1;
      return K_COPY;
    }
    if (phase == PH_G1) {
      phase = PH_SUB;
      return K_NEGP;
    }
    return compare();
  }

  LH_MEM int next(int rid) {
    switch (rid) {
      case K_POW1: return K_POW2;
      case K_POW2: return K_ROOT;
      case K_ROOT: case K_DEC1: case K_LOAD:
        return any(0, J) ? ladder(PH_G2) : K_OUT;
      case K_COPY:
        bit = 63;
        return step();
      case K_NEGP: return e.start(E_A1);
      case E_D4:
        if (e.fb || !((LH_ABS_X >> bit) & 1)) return step();
        return e.start(E_A1);
      case E_A5:
        if (e.s.dbl_any) {
          e.fb = true;
          return E_D1;
        }
        return step();
      case K_CMP: return K_OUT;
      case K_OUT: return -1;
      default: return rid + 1;           // the engine's rounds, K_C1..K_C3
    }
  }

  LH_MEM int np(int rid) {
    if (rid < PC_PROG) return e.np(rid);
    switch (rid) {
      case K_C1: return 3 * J;
      case K_C2: return 2 * J;
      case K_C3: return J;
      default: return 0;
    }
  }

  LH_MEM int nl(int rid) {
    if (rid < PC_PROG) return e.nl(rid);
    switch (rid) {
      case K_POW1: case K_ROOT: case K_DEC1: case K_CMP: return J;
      case K_POW2: return 2 * J;
      case K_LOAD: case K_OUT: return J;
      case K_COPY: case K_NEGP: return 6 * L;
      default: return 0;
    }
  }

  // The compare of job j's target T (affine: psi(Q), or phi(P) for G1)
  // with its accumulator A: t[0] = Z^2, t[1] = T_x, t[2] = T_y; t[3] =
  // Z^3, t[4] = T_x Z^2; t[5] = T_y Z^3.
  LH_MEM fp2_t* pops(int rid, int k, fp2_t& a, fp2_t& b) {
    if (rid < PC_PROG) return e.pops(rid, k, a, b);
    const int per = rid == K_C1 ? 3 : (rid == K_C2 ? 2 : 1);
    const int j = k / per, u = k - per * j;
    fp2_t* t = s.pc.job[j].t;
    const pc_pt& A = s.pc.p[j];
    if (rid == K_C1) {
      if (u == 0) {
        a = A.z;
        b = A.z;
      } else if (g1(j)) {                // (beta x, y)
        a = u == 1 ? s.bx[j] : s.by[j];
        f2_one(b);
        if (u == 1) b.c0 = LH_G1_BETA;
      } else {                           // (cx conj(x), cy conj(y))
        conj(a, u == 1 ? s.bx[j] : s.by[j]);
        b = u == 1 ? LH_PSI_CX : LH_PSI_CY;
      }
      return &t[u];
    }
    if (rid == K_C2) {
      a = u ? t[1] : t[0];
      b = u ? t[0] : A.z;
      return &t[3 + u];
    }
    a = t[2];
    b = t[3];
    return &t[5];
  }

  // Job j's point (x, y) on the card, or infinity where it is off, into
  // both of its slots.
  LH_MEM void set_point(int j, bool on) {
    s.on[j] = on;
    for (int c = 0; c < 3; c++) {
      for (int q = 0; q < 2; q++) {
        fp_t v;
        if (!on) f2_set_inf_co(v, c, q);
        else if (c < 2) v = co(c ? s.by[j] : s.bx[j], q);
        else if (q) set_zero(v);
        else v = LH_ONE;
        co(pt_co(s.pc.p[j], c), q) = v;
        co(pt_co(s.pc.p[J + j], c), q) = v;
      }
    }
  }

  // K_POW1: x to Montgomery form, the right-hand side, its norm's power.
  LH_MEM void pow1(int k) {
    ck_dec& d = s.d[k];
    const int i = l0 + k;
    d.inf = i >= n1 || inf1[i];          // an absent lane is no work
    if (i >= n1) return;
    d.sign = act1[i] != 0;
    fp2_t x;
    load(x, x1 + 24 * (size_t)i);
    d.xz = is_zero(x);
    if (d.inf) return;
    ck_dec_pow1(d, s.bx[k], x);
  }

  // K_ROOT: the root by chi(d1), its check and the wire's sign; the point
  // out and into the ladder's slots.
  LH_MEM void root(int k) {
    ck_dec& d = s.d[k];
    const int i = l0 + k;
    if (i >= n1) {
      set_point(k, false);
      return;
    }
    if (d.inf) {
      fp2_t z;
      set_zero(z);
      store(xs + 24 * (size_t)i, z);
      store(ys + 24 * (size_t)i, z);
      si[i] = 1;
      s.eq[k] = d.xz;                    // the verdict without a check
      set_point(k, false);
      return;
    }
    fp2_t y;
    const bool on_curve = ck_dec_root(y, d);
    s.by[k] = y;
    store(xs + 24 * (size_t)i, s.bx[k]);
    store(ys + 24 * (size_t)i, y);
    si[i] = 0;
    s.eq[k] = on_curve;
    set_point(k, on_curve);
  }

  // K_DEC1: one k_decode_g1 lane in one thread, the point out and, with
  // the check on and the point on the curve, into the ladder's slots.
  LH_MEM void dec1(int k) {
    const int i = l0 + k;
    if (i >= n1) {
      set_point(k, false);
      return;
    }
    fp_t x, xm, t, y, chk;
    load(x, x1 + 12 * (size_t)i);
    if (inf1[i]) {
      set_zero(t);
      store(xs + 12 * (size_t)i, t);
      store(ys + 12 * (size_t)i, t);
      si[i] = 1;
      s.eq[k] = is_zero(x);
      set_point(k, false);
      return;
    }
    ck_dec1& d = s.d[k];
    fmul(xm, x, LH_R2);
    fsqr(t, xm);
    fmul(t, t, xm);
    add(d.rhs, t, LH_B1);
    ck_pow(y, d.rhs, LH_EXP_SQRT_P1, d.tab);
    fsqr(chk, y);
    const bool on_curve = eq(chk, d.rhs);
    fp_t one, c, ny;                     // the sign on the real value
    set_zero(one);
    one.v[0] = 1;
    fmul(c, y, one);
    neg(ny, y);
    const bool flip = gt_half_p(c) != (act1[i] != 0);
#pragma unroll
    for (int w = 0; w < LH_NL; w++) y.v[w] = flip ? ny.v[w] : y.v[w];
    set_zero(s.bx[k]);
    set_zero(s.by[k]);
    s.bx[k].c0 = xm;
    s.by[k].c0 = y;
    store(xs + 12 * (size_t)i, xm);
    store(ys + 12 * (size_t)i, y);
    si[i] = 0;
    s.eq[k] = on_curve;
    set_point(k, on_curve && check);
  }

  // K_LOAD: job j's lane (G1 j < L, G2 j - L).
  LH_MEM void load_job(int j) {
    const bool one = g1(j);
    const int i = l0 + (one ? j : j - L);
    bool on = false;
    set_zero(s.bx[j]);
    set_zero(s.by[j]);
    if (one && i < n1) {
      on = act1[i] && !inf1[i];
      load(s.bx[j].c0, x1 + 12 * (size_t)i);
      load(s.by[j].c0, y1 + 12 * (size_t)i);
    } else if (!one && i < n2) {
      on = act2[i] && !inf2[i];
      load(s.bx[j], x2 + 24 * (size_t)i);
      load(s.by[j], y2 + 24 * (size_t)i);
    }
    set_point(j, on);
  }

  LH_MEM void lin(int rid, int k) {
    if (rid < PC_PROG) {
      e.lin(rid, k);
      return;
    }
    switch (rid) {
      case K_POW1:
        if constexpr (DEC) pow1(k);
        return;
      case K_POW2:                       // d1^e (even k), s^e (odd)
        if constexpr (DEC) {
          ck_dec& d = s.d[k >> 1];
          if (d.inf) return;
          ck_dec_pow2(d, k & 1);
        }
        return;
      case K_ROOT:
        if constexpr (DEC) root(k);
        return;
      case K_DEC1:
        if constexpr (DEC1) dec1(k);
        return;
      case K_LOAD:
        if constexpr (MODE == CK_SUB) load_job(k);
        return;
      case K_COPY: case K_NEGP: {        // G1 job j's operand: acc, or -P
        const int j = k / 6, u = k - 6 * j, c = u >> 1, q = u & 1;
        fp_t v;
        if (rid == K_COPY) {
          v = co(pt_co(s.pc.p[j], c), q);
        } else if (!s.on[j]) {
          f2_set_inf_co(v, c, q);
        } else if (c == 0) {
          v = co(s.bx[j], q);
        } else if (c == 1) {
          neg(v, co(s.by[j], q));
        } else if (q) {
          set_zero(v);
        } else {
          v = LH_ONE;
        }
        co(pt_co(s.pc.p[J + j], c), q) = v;
        return;
      }
      case K_CMP: {                      // psi(Q) == -A; phi(P) == A
        const fp2_t* t = s.pc.job[k].t;
        const pc_pt& A = s.pc.p[k];
        fp2_t y;
        if (g1(k)) y = A.y;
        else neg(y, A.y);
        const bool same = !is_zero(A.z) && eq(t[4], A.x) && eq(t[5], y);
        if (s.on[k]) s.eq[k] = same;
        return;
      }
      default: {                         // K_OUT
        if (DEC || DEC1) {
          const int i = l0 + k;
          if (i >= n1) return;
          if (DEC1) lanes[i] = s.eq[k] ? 1 : 0;
          else if (!s.eq[k]) *ok = 0;
          return;
        }
        const bool one = g1(k);
        const int i = l0 + (one ? k : k - L);
        if (i >= (one ? n1 : n2)) return;
        const bool pass = !s.on[k] || s.eq[k];
        lanes[one ? i : n1 + i] = pass ? 1 : 0;
        if (!pass) *ok = 0;
        return;
      }
    }
  }
};
