// The pairing spread over a block of threads: the Miller loop of one pair
// lane (k_pair_miller_kernel, one block a lane) and the lane product with
// the final exponentiation (k_pair_final_kernel, one block), for k_pair.cu
// and k_each.cu.  It computes what the plain versions of
// crypto/bls/cuda/pairing.py (miller_loop, tower.mul, final_exponentiation)
// compute, word for word: the Fp tower is exact, so any formula for the
// same field value gives the same canonical Montgomery words; T and the
// line coefficients follow pairing.py's doubling_step / addition_step
// (curve.double, curve.add with its exceptional branches) value for value,
// since the lines carry Fp2 factors that only the final exponentiation
// removes.
//
// Design.  What bounds a pairing on this card is the latency of chains of
// Fp products (a CIOS product is ~1,000 dependent 32-bit instructions), not
// bytes or the multiply-add rate: one thread a lane left 131 of 132 SMs
// idle and ran each Fp12 operation as a serial chain out of a local stack.
// Here every Fp12 operation is a few "rounds" separated by __syncthreads:
//   - a product round: each task is one Fp2 product (Karatsuba), spread
//     over three lanes of a warp, each lane one inline CIOS product in
//     registers (bls12_381.cuh mul for k_pair.cu, fp_ptx.cuh fmul for
//     k_each.cu: lh_block's PM), the three crossing by shuffles; so a
//     warp issues one Fp product a round, ten Fp2 products at once;
//   - a linear round: each task is one Fp coordinate of a sum (adds, subs,
//     xi), so the cheap work is spread as thin as the products.
// The state (f, T, temporaries, product scratch) lives in shared memory,
// Fp12 values in w-order: f = sum f_m w^m, m = 0..5 (w^2 = v, w^6 = xi);
// slot w_slot(m) of the (2, 3, 2, 12) layout.  Factors of 2, 3, -1 and xi
// are folded into a product's operands or a sum's terms.  The Miller block's
// first three warps take product tasks and its fourth the sums, so the two
// kinds of a round run side by side; the final exponentiation's rounds are
// one kind or the other, and every thread of its block takes them.
//
// Every round is run from one loop (lh_run) through one product site and
// one linear site, driven by a small uniform state machine (the program's
// next()): the Fp product is compiled once a kernel, nothing is
// __noinline__, and nothing needs a stack.  Control flow is uniform over
// the block (bits of |x|, exponent bits, flags read from shared memory
// after a barrier), so every thread reaches every barrier; an infinity lane
// runs no rounds but the load and the store.
//
// Critical path, in rounds of one Fp2 product (P) or one sum (L):
//   Miller lane: 63 doubling steps of 3 P + 1 L (f^2 as 21 products of
//     pairs f_i f_j with the doubling's second products; the line's a and c
//     with Y3; f^2 times the line with the next step's T squares; the sum),
//     5 addition steps of 5 P + 2 L: ~215 P + ~75 L.
//   final exponentiation: an Fp12 product is 1 P (36 tasks) + 1 L; a
//     cyclotomic squaring 1 P (9 tasks) + 1 L, and a pow's multiplication
//     runs in its squaring's rounds (LSB first); 126 + 3 x 64 squarings,
//     7 products, 3 Frobenius maps (1 P each) and the inversion (9 P + 5 L
//     and one thread's binary extended Euclid): ~330 P + ~330 L.
//   lane product: ceil(m / 3) - 1 steps of three Fp12 products, then a
//     tree of two levels, each 1 P + 1 L.
//
// Without __CUDACC__ the header compiles as plain C++: lh_host_group runs
// the tasks of each round one after another (forward, or backward with the
// linear tasks first, which shows a task that reads what another task of
// its round writes), so a host harness emulates a block.
#pragma once
#include "fp_ptx.cuh"

// Member functions of the round programs (LH_DEV is static on the host).
#ifdef __CUDACC__
#define LH_MEM __device__ __forceinline__
#else
#define LH_MEM inline
#endif

// ------------------------------------------------------------- groups -----

// Karatsuba: three CIOS products (bls12_381.cuh mul(fp2_t)); the host
// group's product task.
LH_DEV void f2_mul(fp2_t& r, const fp2_t& a, const fp2_t& b) {
  fp_t t0, t1, t2, sa, sb;
  mul(t0, a.c0, b.c0);
  mul(t1, a.c1, b.c1);
  add(sa, a.c0, a.c1);
  add(sb, b.c0, b.c1);
  mul(t2, sa, sb);
  sub(r.c0, t0, t1);
  sub(t2, t2, t0);
  sub(r.c1, t2, t1);
}

#ifdef __CUDACC__
// The Fp product of a block's product site: the CIOS `mul` of
// bls12_381.cuh (the pairing's kernels) or the PTX carry-chain `fmul` of
// fp_ptx.cuh (the weighting ladders of points_coop.cuh).
struct lh_cios {
  __device__ __forceinline__ static void f(fp_t& r, const fp_t& a,
                                           const fp_t& b) {
    mul(r, a, b);
  }
};
struct lh_ptx {
  __device__ __forceinline__ static void f(fp_t& r, const fp_t& a,
                                           const fp_t& b) {
    fmul(r, a, b);
  }
};

// A block of NT threads.  A round's product tasks go to threads [0, NP),
// its linear tasks to [NP, NT), or to every thread when the round has no
// product or NP == NT (the final exponentiation's block, whose rounds have
// products or sums, not both; a one-warp Miller block).
//
// A product task (d = x y in Fp2) takes three lanes of a warp, ten tasks a
// warp: lane 3s + r computes the operands and one inline CIOS product of
// Karatsuba (r = 0: x0 y0, 1: x1 y1, 2: (x0 + x1)(y0 + y1)); the three
// products cross by shuffles and lanes r = 0, 1 store d's coordinates.  A
// warp's instruction stream is then one Fp product a round, not three.
template <int NP, int NT, class PM = lh_cios>
struct lh_block {
  int t;

  template <class FP>
  __device__ __forceinline__ void prods(int np, FP fp) {
    const int lane = t & 31, slot = lane / 3, r = lane - 3 * slot;
    const int l0 = 3 * slot;
    for (int base = (t >> 5) * 10; base < np; base += 10 * (NP / 32)) {
      int k = base + slot;
      bool act = slot < 10 && k < np;
      fp2_t* d = nullptr;
      fp_t p;
      set_zero(p);
      if (act) {
        fp2_t x, y;
        d = fp(k, x, y);
        fp_t a, b;
        if (r == 0) {
          a = x.c0;
          b = y.c0;
        } else if (r == 1) {
          a = x.c1;
          b = y.c1;
        } else {
          add(a, x.c0, x.c1);
          add(b, y.c0, y.c1);
        }
        PM::f(p, a, b);
      }
      fp_t p0, p1, p2;
#pragma unroll
      for (int w = 0; w < LH_NL; w++) {
        p0.v[w] = __shfl_sync(0xffffffffu, p.v[w], l0);
        p1.v[w] = __shfl_sync(0xffffffffu, p.v[w], l0 + 1);
        p2.v[w] = __shfl_sync(0xffffffffu, p.v[w], l0 + 2);
      }
      if (act && r == 0) {
        sub(d->c0, p0, p1);
      } else if (act && r == 1) {
        sub(p2, p2, p0);
        sub(d->c1, p2, p1);
      }
    }
  }

  // With NP == NT a round with both kinds runs its products, then its
  // sums, on every thread: a round's tasks are independent (the host
  // group's two orders check it), so no barrier parts them.
  template <class FP, class FL>
  __device__ __forceinline__ void round(int np, FP fp, int nl, FL fl) {
    const bool split = np != 0 && NP < NT;
    if (np != 0 && t < NP) prods(np, fp);
    if (!split || t >= NP) {
      const int first = split ? NP : 0;
      for (int k = t - first; k < nl; k += NT - first) fl(k);
    }
    __syncthreads();
  }
};
#else
struct lh_host_group {
  int rev;
  template <class FP>
  void prod(int k, FP fp) {
    fp2_t x, y;
    fp2_t* d = fp(k, x, y);
    f2_mul(*d, x, y);
  }
  template <class FP, class FL>
  void round(int np, FP fp, int nl, FL fl) {
    if (rev) {
      for (int k = nl - 1; k >= 0; k--) fl(k);
      for (int k = np - 1; k >= 0; k--) prod(k, fp);
    } else {
      for (int k = 0; k < np; k++) prod(k, fp);
      for (int k = 0; k < nl; k++) fl(k);
    }
  }
};
#endif

// ---------------------------------------------------------- Fp2 sums -----

LH_DEV void f2_dbl(fp2_t& r, const fp2_t& a) { add(r, a, a); }
LH_DEV void f2_tri(fp2_t& r, const fp2_t& a) {
  fp2_t t;
  add(t, a, a);
  add(r, t, a);
}
LH_DEV void f2_one(fp2_t& r) {
  r.c0 = LH_ONE;
  set_zero(r.c1);
}

// Coordinate q of an Fp2 element, and coordinate q of xi a.
LH_DEV fp_t& co(fp2_t& a, int q) { return q ? a.c1 : a.c0; }
LH_DEV const fp_t& co(const fp2_t& a, int q) { return q ? a.c1 : a.c0; }
LH_DEV void xi_co(fp_t& r, const fp2_t& a, int q) {
  if (q) add(r, a.c0, a.c1); else sub(r, a.c0, a.c1);
}

// Fp12 layout slot of w^m: c0.c0 c0.c1 c0.c2 c1.c0 c1.c1 c1.c2 hold
// w^0 w^2 w^4 w^1 w^3 w^5.
LH_DEV int w_slot(int m) { return (m & 1) * 3 + (m >> 1); }

// ------------------------------------------------------------- runner -----

// A round's two sites, as one functor whose calls are forced inline (a
// large linear site, such as k_decode's powers, left out of line would
// take the program's address and put the program on a stack).
template <class PR>
struct lh_sites {
  PR& pr;
  int rid;
  LH_MEM fp2_t* operator()(int k, fp2_t& x, fp2_t& y) const {
    return pr.pops(rid, k, x, y);
  }
  LH_MEM void operator()(int k) const { pr.lin(rid, k); }
};

// Runs pr's rounds until next() returns -1.  Every round goes through the
// one product site (the group's) and the one linear site below.
template <class G, class PR>
LH_DEV void lh_run(G& g, PR& pr) {
  for (int rid = pr.first(); rid >= 0; rid = pr.next(rid)) {
    const lh_sites<PR> site{pr, rid};
    g.round(pr.np(rid), site, pr.nl(rid), site);
  }
}

// -------------------------------------------------------- Miller lane -----

// f^2 as the 21 products f_i f_j, i <= j (k = pair index); pair_of maps k
// to (i, j), pair_index back.  Slot 21 of pp stays zero.
LH_DEV void pair_of(int k, int& i, int& j) {
  i = 0;
  while (k >= 6 - i) {
    k -= 6 - i;
    i++;
  }
  j = i + k;
}
LH_DEV int pair_index(int i, int j) {
  return i * 6 - i * (i - 1) / 2 + (j - i);
}

// w-powers of the line's coefficients b, c, a (line = b w + c w^3 + a w^4:
// a v^2 + b w + c v w with v = w^2).
LH_DEV int line_pow(int jj) { return jj == 0 ? 1 : (jj == 1 ? 3 : 4); }

struct mill_t {
  fp2_t f[6], f2[6], pp[22], lp[18];
  fp2_t X, Y, Z, xq, yq, xp, yp;         // T, Q, P (xp, yp as (x, 0))
  fp2_t A, B, Z2, YZ;                    // X^2, Y^2, Z^2, Y Z of T
  fp2_t X3c, X2Z2, YZ3, C, TT, Fq;       // X^3, X^2 Z^2, Y Z^3, B^2,
                                         // (X + B)^2, (3A)^2
  fp2_t Y3p, la, lb, lc;                 // E (D - X3); the line a, b, c
  fp2_t Z3v, xqZ2, yqZ3, ZD, Nxq, yqZD, I, RR, J, V, Y3a, SJ, Xn, Yn, Zn;
  int tinf, h0, r0;
};

enum {
  M_LOAD, M_T1, M_D1, M_D2, M_D3, M_D4, M_A1, M_A2, M_A3, M_A4, M_A5,
  M_S1, M_S2, M_S3, M_A6, M_A7, M_OUT
};

// One lane's Miller loop (pairing.py miller_loop): f over the 63 bits of
// |x| below the leading one, conjugated, stored at out (144 words, the
// (2, 3, 2, 12) layout); f = 1 for an inactive lane.  xp, yp: 12 words
// each, or null for -g1; xq, yq: 24 words each.
struct mill_prog {
  mill_t& s;
  const uint32_t *px, *py, *qx, *qy;
  bool inactive;
  uint32_t* out;
  int i;

  LH_MEM int first() { return M_LOAD; }

  LH_MEM int step_done() {
    if (i == 0) return M_OUT;
    i--;
    return M_D1;
  }

  LH_MEM int next(int rid) {
    switch (rid) {
      case M_LOAD: return inactive ? M_OUT : M_T1;
      case M_T1: i = 62; return M_D1;
      case M_D4: return ((LH_ABS_X >> i) & 1) ? M_A1 : step_done();
      case M_A5: return (!s.tinf && s.h0 && s.r0) ? M_S1 : M_A6;
      case M_S3: return M_A6;
      case M_A7: return step_done();
      case M_OUT: return -1;
      default: return rid + 1;
    }
  }

  LH_MEM int np(int rid) {
    switch (rid) {
      case M_T1: case M_A7: return 4;
      case M_D1: return 27;
      case M_D2: return 3;
      case M_D3: return 22;
      case M_A1: case M_A2: case M_A5: return 2;
      case M_A3: return 6;
      case M_A4: return 20;
      case M_S1: return 3;
      case M_S2: return 1;
      default: return 0;
    }
  }

  LH_MEM int nl(int rid) {
    switch (rid) {
      case M_LOAD: return 14;
      case M_D2: return 18;
      case M_D3: case M_S3: return 2;
      case M_D4: return 12;
      case M_A1: case M_A2: case M_A3: return 1;
      case M_A5: return 16;
      case M_S2: return 4;
      case M_A6: return 6;
      case M_OUT: return 12;
      default: return 0;
    }
  }

  // T's squares (X^2, Y^2, Z^2, Y Z), with Y given.
  LH_MEM fp2_t* t1_ops(int k, const fp2_t& y, fp2_t& a, fp2_t& b) {
    switch (k) {
      case 0: a = s.X; b = s.X; return &s.A;
      case 1: a = y; b = y; return &s.B;
      case 2: a = s.Z; b = s.Z; return &s.Z2;
      default: a = y; b = s.Z; return &s.YZ;
    }
  }

  // pt_double's second products, and doubling_step's (k < 3).
  LH_MEM fp2_t* dbl2_ops(int k, fp2_t& a, fp2_t& b) {
    switch (k) {
      case 0: a = s.A; b = s.X; return &s.X3c;
      case 1: a = s.A; b = s.Z2; return &s.X2Z2;
      case 2: a = s.YZ; b = s.Z2; return &s.YZ3;
      case 3: a = s.B; b = s.B; return &s.C;
      case 4: add(a, s.X, s.B); b = a; return &s.TT;
      default: f2_tri(a, s.A); b = a; return &s.Fq;
    }
  }

  // D = 2((X + B)^2 - A - C), X3 = F - 2D.
  LH_MEM void dbl_x3(fp2_t& d, fp2_t& x3) {
    sub(d, s.TT, s.A);
    sub(d, d, s.C);
    f2_dbl(d, d);
    fp2_t d2;
    f2_dbl(d2, d);
    sub(x3, s.Fq, d2);
  }

  // Y3 = E (D - X3) into Y3p.
  LH_MEM fp2_t* dbl_y3_ops(fp2_t& a, fp2_t& b) {
    fp2_t d, x3;
    dbl_x3(d, x3);
    f2_tri(a, s.A);
    sub(b, d, x3);
    return &s.Y3p;
  }

  // lp[3 i + jj] = src_i * line_jj, with xi where w-powers wrap.
  LH_MEM fp2_t* line_ops(int k, const fp2_t* src, const fp2_t& lb, fp2_t& a,
                         fp2_t& b) {
    int i = k / 3, jj = k - 3 * (k / 3);
    a = src[i];
    if (i + line_pow(jj) >= 6) mul_by_xi(a, a);
    b = jj == 0 ? lb : (jj == 1 ? s.lc : s.la);
    return &s.lp[k];
  }

  LH_MEM fp2_t* pops(int rid, int k, fp2_t& a, fp2_t& b) {
    switch (rid) {
      case M_T1: case M_A7: return t1_ops(k, s.Y, a, b);
      case M_D1: {
        if (k >= 21) return dbl2_ops(k - 21, a, b);
        int i, j;
        pair_of(k, i, j);
        a = s.f[i];
        if (i != j) f2_dbl(a, a);
        if (i + j >= 6) mul_by_xi(a, a);
        b = s.f[j];
        return &s.pp[k];
      }
      case M_D2:
        if (k == 0) return dbl_y3_ops(a, b);
        if (k == 1) {                    // a = 2 Y Z^3 yp
          f2_dbl(a, s.YZ3);
          b = s.yp;
          return &s.la;
        }
        f2_tri(a, s.X2Z2);               // c = -3 X^2 Z^2 xp
        neg(a, a);
        b = s.xp;
        return &s.lc;
      case M_D3: {
        if (k < 18) return line_ops(k, s.f2, s.lb, a, b);
        fp2_t y, c8;                     // the new Y = E (D - X3) - 8C
        f2_dbl(c8, s.C);
        f2_dbl(c8, c8);
        f2_dbl(c8, c8);
        sub(y, s.Y3p, c8);
        return t1_ops(k - 18, y, a, b);
      }
      case M_A1:
        if (k == 0) { a = s.Z; b = s.Z2; return &s.Z3v; }
        a = s.xq; b = s.Z2; return &s.xqZ2;
      case M_A2:
        if (k == 0) { a = s.yq; b = s.Z3v; return &s.yqZ3; }
        a = s.Z; sub(b, s.xqZ2, s.X); return &s.ZD;
      case M_A3: {
        fp2_t n, d;
        sub(n, s.yqZ3, s.Y);               // N = S2 - S1
        sub(d, s.xqZ2, s.X);               // D = H = U2 - U1
        switch (k) {
          case 0: a = n; b = s.xq; return &s.Nxq;
          case 1: a = s.yq; b = s.ZD; return &s.yqZD;
          case 2: a = s.ZD; b = s.yp; return &s.la;
          case 3: neg(a, n); b = s.xp; return &s.lc;
          case 4: f2_dbl(a, d); b = a; return &s.I;
          default: f2_dbl(a, n); b = a; return &s.RR;
        }
      }
      case M_A4: {
        if (k < 18) {
          fp2_t lb;
          sub(lb, s.Nxq, s.yqZD);          // b = N xq - Z D yq
          return line_ops(k, s.f, lb, a, b);
        }
        if (k == 18) { sub(a, s.xqZ2, s.X); b = s.I; return &s.J; }
        a = s.X; b = s.I; return &s.V;
      }
      case M_A5: {
        if (k == 1) { a = s.Y; b = s.J; return &s.SJ; }
        fp2_t x3, v2;                      // Y3 = 2N (V - X3)
        sub(x3, s.RR, s.J);
        f2_dbl(v2, s.V);
        sub(x3, x3, v2);
        sub(a, s.yqZ3, s.Y);
        f2_dbl(a, a);
        sub(b, s.V, x3);
        return &s.Y3a;
      }
      case M_S1: return dbl2_ops(k + 3, a, b);
      default: return dbl_y3_ops(a, b);  // M_S2
    }
  }

  // f^2 from pp: sum over i of pp(i, j), j = m - i mod 6, j >= i.
  LH_MEM void sq_sum(int m, int q) {
    fp_t acc;
    set_zero(acc);
    for (int i = 0; i < 6; i++) {
      int j = (m - i + 6) % 6;
      int idx = j >= i ? pair_index(i, j) : 21;
      add(acc, acc, co(s.pp[idx], q));
    }
    co(s.f2[m], q) = acc;
  }

  // f from lp: sum over jj of lp(m - e_jj mod 6, jj).
  LH_MEM void line_sum(int m, int q) {
    fp_t acc;
    set_zero(acc);
    for (int jj = 0; jj < 3; jj++) {
      int i = (m - line_pow(jj) + 6) % 6;
      add(acc, acc, co(s.lp[3 * i + jj], q));
    }
    co(s.f[m], q) = acc;
  }

  LH_MEM void lin(int rid, int k) {
    int q = k & 1;
    switch (rid) {
      case M_LOAD:
        if (k == 0) {
          if (px) load(s.xp.c0, px); else s.xp.c0 = LH_G1_X;
          set_zero(s.xp.c1);
        } else if (k == 1) {
          if (py) load(s.yp.c0, py); else s.yp.c0 = LH_G1_NEG_Y;
          set_zero(s.yp.c1);
        } else if (k < 4) {
          load(co(s.xq, k - 2), qx + 12 * (k - 2));
          co(s.X, k - 2) = co(s.xq, k - 2);
        } else if (k < 6) {
          load(co(s.yq, k - 4), qy + 12 * (k - 4));
          co(s.Y, k - 4) = co(s.yq, k - 4);
        } else if (k == 6) {
          f2_one(s.Z);
        } else if (k == 7) {
          f2_one(s.f[0]);
        } else if (k < 13) {
          set_zero(s.f[k - 7]);
        } else {
          set_zero(s.pp[21]);
        }
        return;
      case M_D2: {
        if (k < 12) { sq_sum(k >> 1, q); return; }
        fp_t t, u;
        if (k < 14) {                    // X3 = F - 2D, D = 2(TT - A - C)
          sub(t, co(s.TT, q), co(s.A, q));
          sub(t, t, co(s.C, q));
          add(t, t, t);
          add(t, t, t);
          sub(co(s.X, q), co(s.Fq, q), t);
        } else if (k < 16) {             // Z3 = 2 Y Z
          add(co(s.Z, q), co(s.YZ, q), co(s.YZ, q));
        } else {                         // b = 3 X^3 - 2 Y^2
          add(t, co(s.X3c, q), co(s.X3c, q));
          add(t, t, co(s.X3c, q));
          add(u, co(s.B, q), co(s.B, q));
          sub(co(s.lb, q), t, u);
        }
        return;
      }
      case M_D3: case M_S3: {            // Y3 = E (D - X3) - 8C
        fp_t c8;
        add(c8, co(s.C, q), co(s.C, q));
        add(c8, c8, c8);
        add(c8, c8, c8);
        sub(co(rid == M_D3 ? s.Y : s.Yn, q), co(s.Y3p, q), c8);
        return;
      }
      case M_D4: line_sum(k >> 1, q); return;
      case M_A1: s.tinf = is_zero(s.Z); return;
      case M_A2: {
        fp2_t d;
        sub(d, s.xqZ2, s.X);
        s.h0 = is_zero(d);
        return;
      }
      case M_A3: {
        fp2_t n;
        sub(n, s.yqZ3, s.Y);
        s.r0 = is_zero(n);
        return;
      }
      case M_A5: {
        if (k < 12) { line_sum(k >> 1, q); return; }
        if (k < 14) {                    // X3 = RR - J - 2V
          fp_t t;
          sub(t, co(s.RR, q), co(s.J, q));
          sub(t, t, co(s.V, q));
          sub(co(s.Xn, q), t, co(s.V, q));
        } else {                         // Z3 = 2 Z D
          add(co(s.Zn, q), co(s.ZD, q), co(s.ZD, q));
        }
        return;
      }
      case M_S2: {
        if (k < 2) {
          fp_t t;
          sub(t, co(s.TT, q), co(s.A, q));
          sub(t, t, co(s.C, q));
          add(t, t, t);
          add(t, t, t);
          sub(co(s.Xn, q), co(s.Fq, q), t);
        } else {
          add(co(s.Zn, q), co(s.YZ, q), co(s.YZ, q));
        }
        return;
      }
      case M_A6: {                       // pt_add's result
        int c = k >> 1;
        fp2_t* dst = c == 0 ? &s.X : (c == 1 ? &s.Y : &s.Z);
        fp_t r;
        if (s.tinf) {                    // T at infinity: Q
          if (c == 0) r = co(s.xq, q);
          else if (c == 1) r = co(s.yq, q);
          else if (q) set_zero(r);
          else r = LH_ONE;
        } else if (s.h0 && !s.r0) {      // T == -Q: infinity (0, 1, 0)
          if (c == 1 && !q) r = LH_ONE; else set_zero(r);
        } else if (c == 0) {
          r = co(s.Xn, q);
        } else if (c == 2) {
          r = co(s.Zn, q);
        } else if (s.h0) {               // T == Q: 2T
          r = co(s.Yn, q);
        } else {                         // Y3 = 2N (V - X3) - 2 Y J
          fp_t sj;
          add(sj, co(s.SJ, q), co(s.SJ, q));
          sub(r, co(s.Y3a, q), sj);
        }
        co(*dst, q) = r;
        return;
      }
      default: {                         // M_OUT: conj(f), or 1
        int m = k >> 1;
        fp_t r = co(s.f[m], q);
        if (m & 1) neg(r, r);
        store(out + 24 * w_slot(m) + 12 * q, r);
        return;
      }
    }
  }
};

// ------------------------------------- lane product, final exponentiation --

#define LH_FIN_K 3         // accumulators of the lane product
#define LH_FIN_NB 15       // Fp12 buffers
enum { B_T = 6, B_M, B_A, B_B, B_C, B_BASE, B_RES = B_BASE + 2 };

struct fin_t {
  fp2_t b[LH_FIN_NB][6];   // 0..5 the accumulators (0: the product), then
                           // T, M, A, B, C, pow base x2, pow result x2
  fp2_t P[LH_FIN_K * 36];
  fp2_t U[3], W[3], qq[6], dd[3], d, nrm, ninv, dinv, Ui[3];
};

enum {
  F_LOAD, F_LMUL, F_LCOMB, F_TMUL, F_TCOMB, F_MULP, F_MULC, F_FROB,
  F_PINIT, F_PSTEP, F_PCOMB, F_PFIN, F_I1, F_I2, F_I3, F_I4, F_I5, F_I6,
  F_I7, F_I8, F_I9, F_I10, F_I11, F_I12, F_OUT, F_OUTP
};

// The final exponentiation (pairing.py final_exponentiation) as a list
// of Fp12 operations: kind, destination, operands, conjugation flags (1: a,
// 2: b), and the Frobenius power or the exponent (0: e1, 1: |x|).
enum { OP_INV, OP_MUL, OP_FROB, OP_POW, OP_END };
struct fe_op { uint8_t kind, dst, a, b, arg; };
LH_CONST fe_op LH_FE_OPS[] = {
    {OP_INV, B_T, 0, 0, 0},        // t = f^-1
    {OP_MUL, B_M, 0, B_T, 1},      // m = conj(f) t       = f^(p^6 - 1)
    {OP_FROB, B_T, B_M, 0, 2},     // t = m^(p^2)
    {OP_MUL, B_M, B_T, B_M, 0},    // m = t m             ^(p^2 + 1)
    {OP_POW, B_A, B_M, 0, 0},      // a = m^e1
    {OP_POW, B_T, B_A, 0, 1},      // t = a^|x|
    {OP_FROB, B_B, B_A, 0, 1},     // b = a^p
    {OP_MUL, B_B, B_T, B_B, 1},    // b = conj(t) b       = a^(x + p)
    {OP_POW, B_T, B_B, 0, 1},      // t = b^|x|
    {OP_POW, B_T, B_T, 0, 1},      // t = b^(x^2)
    {OP_FROB, B_C, B_B, 0, 2},     // c = b^(p^2)
    {OP_MUL, B_C, B_C, B_B, 2},    // c = c conj(b)       = b^(p^2 - 1)
    {OP_MUL, B_C, B_T, B_C, 0},    // c = t c
    {OP_MUL, B_A, B_C, B_M, 0},    // r = c m
    {OP_END, B_A, 0, 0, 0},
};

// Bit i of the exponent (0: e1, 4 words; 1: |x|), and its top set bit.
LH_DEV int exp_bit(int e, int i) {
  if (e) return (int)((LH_ABS_X >> i) & 1);
  return (int)((LH_E1[i >> 5] >> (i & 31)) & 1);
}
LH_DEV int exp_top(int e) {
  int top = e ? 63 : 127;
  while (top > 0 && !exp_bit(e, top)) top--;
  return top;
}

// The product of m Fp12 values at f_all (the (2, 3, 2, 12) layout, 144
// words each; m = 0 gives 1); with FE, its final exponentiation, stored at
// out with ok = is_one; without, the product stored at out.  With f_b set
// (m = 2, k_ring_mul), value 1 loads from f_b instead of f_all + 144.
struct fin_prog {
  fin_t& s;
  const uint32_t* f_all;
  int m;
  bool fe;
  uint32_t* out;
  uint8_t* ok;
  int k0, base, cnt, w;              // lane product
  int op;                            // FE operation
  int bit, top, bb, rb, have;        // pow state
  const uint32_t* f_b;               // value 1's own source, or null

  LH_MEM int first() { return F_LOAD; }

  LH_MEM fe_op cur() { return LH_FE_OPS[op]; }

  LH_MEM int start_op() {
    const fe_op o = cur();
    switch (o.kind) {
      case OP_INV: return F_I1;
      case OP_MUL: return F_MULP;
      case OP_FROB: return F_FROB;
      case OP_POW: return F_PINIT;
      default: return F_OUT;
    }
  }
  LH_MEM int op_done() {
    op++;
    return start_op();
  }
  LH_MEM int tree_or_done() {
    if (w > 1) {
      cnt = w >> 1;
      return F_TMUL;
    }
    if (!fe) return F_OUTP;
    op = 0;
    return start_op();
  }
  LH_MEM int lane_step() {
    if (base < m) {
      cnt = m - base < k0 ? m - base : k0;
      return F_LMUL;
    }
    w = k0;
    return tree_or_done();
  }

  LH_MEM int next(int rid) {
    switch (rid) {
      case F_LOAD: base = k0; return lane_step();
      case F_LMUL: return F_LCOMB;
      case F_LCOMB: base += cnt; return lane_step();
      case F_TMUL: return F_TCOMB;
      case F_TCOMB: w = (w + 1) >> 1; return tree_or_done();
      case F_MULP: return F_MULC;
      case F_PINIT:
        bit = 0;
        top = exp_top(cur().arg);
        bb = rb = have = 0;
        return F_PSTEP;
      case F_PSTEP: return F_PCOMB;
      case F_PCOMB:
        if (exp_bit(cur().arg, bit)) {
          have = 1;
          rb ^= 1;
        }
        if (bit < top) bb ^= 1;
        bit++;
        return bit <= top ? F_PSTEP : F_PFIN;
      case F_I12: case F_MULC: case F_FROB: case F_PFIN: return op_done();
      case F_OUT: case F_OUTP: return -1;
      default: return rid + 1;       // F_I1 .. F_I11
    }
  }

  LH_MEM int np(int rid) {
    switch (rid) {
      case F_LMUL: return cnt * 36;
      case F_TMUL: return cnt * 36;
      case F_MULP: return 36;
      case F_FROB: return 6;
      case F_PSTEP:
        return (bit < top ? 9 : 0) + (exp_bit(cur().arg, bit) && have ? 36 : 0);
      case F_I1: case F_I11: return 18;
      case F_I3: return 6;
      case F_I5: case F_I10: return 3;
      case F_I7: case F_I9: return 1;
      default: return 0;
    }
  }

  LH_MEM int nl(int rid) {
    switch (rid) {
      case F_LOAD: return 6 * k0;
      case F_LCOMB: case F_TCOMB: return 12 * cnt;
      case F_MULC: case F_PINIT: case F_PFIN: case F_I12: case F_OUTP:
        return 12;
      case F_PCOMB: return 24;
      case F_I2: case F_I4: return 6;
      case F_I6: return 2;
      case F_I8: return 1;
      case F_OUT: return 13;
      default: return 0;
    }
  }

  // P[at + 6 i + j] = (xi? a_i) b_j over w-order Fp12 operands, with conj
  // of a and b (odd w-powers negated) by flag.
  LH_MEM fp2_t* f12_ops(int k, const fp2_t* x, const fp2_t* y, int conj,
                        int at, fp2_t& a, fp2_t& b) {
    int i = k / 6, j = k - 6 * (k / 6);
    a = x[i];
    if ((conj & 1) && (i & 1)) neg(a, a);
    if (i + j >= 6) mul_by_xi(a, a);
    b = y[j];
    if ((conj & 2) && (j & 1)) neg(b, b);
    return &s.P[at + k];
  }

  // Fp6 products over the even (h = 0) or odd (h = 1) w-powers of x: P[at +
  // 3 i + j] = (xi? x_{2i+h}) y_{ys j}.
  LH_MEM fp2_t* f6_ops(int k, const fp2_t* x, int h, const fp2_t* y, int ys,
                       int at, fp2_t& a, fp2_t& b) {
    int i = k / 3, j = k - 3 * (k / 3);
    a = x[2 * i + h];
    if (i + j >= 3) mul_by_xi(a, a);
    b = y[ys * j];
    return &s.P[at + k];
  }

  LH_MEM fp2_t* pops(int rid, int k, fp2_t& a, fp2_t& b) {
    const fe_op o = cur();
    switch (rid) {
      case F_LMUL: {                 // acc_j *= f_all[base + j]
        int j = k / 36, r = k - 36 * (k / 36);
        int i = r / 6, jj = r - 6 * (r / 6);
        a = s.b[j][i];
        if (i + jj >= 6) mul_by_xi(a, a);
        load(b, f_all + 144 * (size_t)(base + j) + 24 * w_slot(jj));
        return &s.P[k];
      }
      case F_TMUL: {                 // acc_j *= acc_{j + ceil(w / 2)}
        int j = k / 36;
        return f12_ops(k - 36 * j, s.b[j], s.b[j + ((w + 1) >> 1)], 0, 36 * j,
                       a, b);
      }
      case F_MULP: return f12_ops(k, s.b[o.a], s.b[o.b], o.arg, 0, a, b);
      case F_FROB: {                 // conj^k'd coefficient times gamma_k
        a = s.b[o.a][k];
        if (o.arg == 1) neg(a.c1, a.c1);
        b = o.arg == 1 ? LH_GAMMA1[w_slot(k)] : LH_GAMMA2[w_slot(k)];
        return &s.b[o.dst][k];
      }
      case F_PSTEP: {
        const fp2_t* x = s.b[B_BASE + bb];
        if (bit < top) {
          if (k < 9) {               // block (f_u, f_{u+3}): squares, product
            int u = k / 3, r = k - 3 * (k / 3);
            a = x[u + (r == 1 ? 3 : 0)];
            b = x[u + (r == 0 ? 0 : 3)];
            return &s.P[k];
          }
          k -= 9;
        }
        return f12_ops(k, s.b[B_RES + rb], x, 0, 9, a, b);
      }
      case F_I1: {                   // c0^2, c1^2
        int h = k / 9;
        return f6_ops(k - 9 * h, s.b[o.a], h, s.b[o.a] + h, 2, 9 * h, a, b);
      }
      case F_I3: {
        switch (k) {
          case 0: a = s.U[0]; b = s.U[0]; break;
          case 1: mul_by_xi(a, s.U[1]); b = s.U[2]; break;
          case 2: mul_by_xi(a, s.U[2]); b = s.U[2]; break;
          case 3: a = s.U[0]; b = s.U[1]; break;
          case 4: a = s.U[1]; b = s.U[1]; break;
          default: a = s.U[0]; b = s.U[2]; break;
        }
        return &s.qq[k];
      }
      case F_I5: {
        if (k == 0) { a = s.U[0]; b = s.W[0]; }
        else if (k == 1) { mul_by_xi(a, s.U[1]); b = s.W[2]; }
        else { mul_by_xi(a, s.U[2]); b = s.W[1]; }
        return &s.dd[k];
      }
      case F_I7: a = s.d; conj(b, s.d); return &s.nrm;
      case F_I9: conj(a, s.d); b = s.ninv; return &s.dinv;
      case F_I10: a = s.W[k]; b = s.dinv; return &s.Ui[k];
      default: {                     // F_I11: (c0, c1) times U^-1
        int h = k / 9;
        return f6_ops(k - 9 * h, s.b[o.a], h, s.Ui, 1, 9 * h, a, b);
      }
    }
  }

  // Coordinate q of sum_i P[at + n i + (m - i mod n)].
  LH_MEM void cyc_sum(fp_t& acc, int n, int m, int q, int at) {
    set_zero(acc);
    for (int i = 0; i < n; i++)
      add(acc, acc, co(s.P[at + n * i + (m - i + n) % n], q));
  }

  LH_MEM void lin(int rid, int k) {
    const fe_op o = cur();
    int q = k & 1, m = (k >> 1) % 6;
    fp_t r;
    switch (rid) {
      case F_LOAD: {
        int j = k / 6, mm = k - 6 * j;
        if (this->m == 0) {             // no value: the product is 1
          if (mm == 0) f2_one(s.b[0][0]); else set_zero(s.b[0][mm]);
        } else {
          const uint32_t* f = j == 1 && f_b ? f_b : f_all + 144 * (size_t)j;
          load(s.b[j][mm], f + 24 * w_slot(mm));
        }
        return;
      }
      case F_LCOMB: case F_TCOMB: {
        int j = k / 12;
        cyc_sum(r, 6, m, q, 36 * j);
        co(s.b[j][m], q) = r;
        return;
      }
      case F_MULC: cyc_sum(r, 6, m, q, 0); co(s.b[o.dst][m], q) = r; return;
      case F_PINIT: co(s.b[B_BASE][m], q) = co(s.b[o.a][m], q); return;
      case F_PCOMB: {
        if (k < 12) {                // the cyclotomic square of base
          if (bit >= top) return;
          const fp2_t* f = s.b[B_BASE + bb];
          fp_t u, v, d;
          if (!(m & 1)) {            // 3 (P_3b + xi P_3b+1) - 2 f_m
            int b3 = 3 * (m >> 1);
            xi_co(v, s.P[b3 + 1], q);
            add(u, co(s.P[b3], q), v);
          } else {                   // 6 (xi?) P_3b+2 + 2 f_m
            int b3 = 3 * (((m - 1) >> 1) + 2) % 9;
            if (m == 1) xi_co(v, s.P[b3 + 2], q); else v = co(s.P[b3 + 2], q);
            add(u, v, v);
          }
          add(r, u, u);
          add(r, r, u);
          add(d, co(f[m], q), co(f[m], q));
          if (m & 1) add(r, r, d); else sub(r, r, d);
          co(s.b[B_BASE + (bb ^ 1)][m], q) = r;
        } else {                     // the result: times base, or base
          if (!exp_bit(o.arg, bit)) return;
          if (have) cyc_sum(r, 6, m, q, 9);
          else r = co(s.b[B_BASE + bb][m], q);
          co(s.b[B_RES + (rb ^ 1)][m], q) = r;
        }
        return;
      }
      case F_PFIN: co(s.b[o.dst][m], q) = co(s.b[B_RES + rb][m], q); return;
      case F_I2: {                   // U = c0^2 - v c1^2
        int mm = k >> 1;
        fp_t t0, t1;
        cyc_sum(t0, 3, mm, q, 0);
        if (mm == 0) {               // (v t1)_0 = xi t1_2
          fp2_t t;
          cyc_sum(t.c0, 3, 2, 0, 9);
          cyc_sum(t.c1, 3, 2, 1, 9);
          xi_co(t1, t, q);
        } else {
          cyc_sum(t1, 3, mm - 1, q, 9);
        }
        sub(co(s.U[mm], q), t0, t1);
        return;
      }
      case F_I4: {                   // W = (U0^2 - xi U1 U2, xi U2^2 - U0 U1,
        int mm = k >> 1;             //      U1^2 - U0 U2)
        sub(co(s.W[mm], q), co(s.qq[2 * mm], q), co(s.qq[2 * mm + 1], q));
        return;
      }
      case F_I6:
        add(r, co(s.dd[0], q), co(s.dd[1], q));
        add(co(s.d, q), r, co(s.dd[2], q));
        return;
      case F_I8:
        fp_inv_vt(s.ninv.c0, s.nrm.c0);
        set_zero(s.ninv.c1);
        return;
      case F_I12: {                  // (c0 U^-1, -(c1 U^-1))
        int mm = k >> 1, h = mm & 1;
        cyc_sum(r, 3, mm >> 1, q, 9 * h);
        if (h) neg(r, r);
        co(s.b[o.dst][mm], q) = r;
        return;
      }
      case F_OUTP:
        store(out + 24 * w_slot(m) + 12 * q, co(s.b[0][m], q));
        return;
      default: {                     // F_OUT
        const fp2_t* g = s.b[o.dst];
        if (k < 12) {
          store(out + 24 * w_slot(m) + 12 * q, co(g[m], q));
          return;
        }
        fp2_t one;
        f2_one(one);
        bool is1 = eq(g[0], one);
        for (int i = 1; i < 6; i++) is1 = is1 && is_zero(g[i]);
        ok[0] = is1 ? 1 : 0;
        return;
      }
    }
  }
};

// k0: accumulators the lane product starts with (1 when m = 0).
LH_DEV int fin_k0(int m) { return m < 1 ? 1 : (m < LH_FIN_K ? m : LH_FIN_K); }
