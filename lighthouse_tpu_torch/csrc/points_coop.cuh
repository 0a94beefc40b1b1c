// The weighting ladders of batch verification spread over a block of
// threads, for k_points.cu: one lane's G1 and G2 ladders side by side
// (pc_ladder, one block a lane), the sum of the weighted signatures and
// the mask variant's per-set key sums (pc_reduce, one block; k_ring.cu's
// cross-shard G2 sum too).  They compute what the plain versions of
// crypto/bls/cuda/staged.py k_points_plain and k_ring_sum_plain compute:
// the affine outputs are unique, so any formula gives the same canonical
// Montgomery words.
//
// Design.  As in pair_coop.cuh, a lane's dependent chain of Fp products is
// cut into rounds separated by __syncthreads, each round's Fp2 products
// spread over three lanes of a warp (lh_block, here with the PTX
// carry-chain fmul of fp_ptx.cuh at its product site), its sums over one
// Fp coordinate a task; the state lives in shared memory, every round goes
// through one product site and one linear site (lh_run), and nothing needs
// a stack.  A G1 value is an Fp2 value with c1 = 0 (every operation keeps
// c1 = 0), so the two groups run one set of formulas as two "jobs" of the
// same rounds and the G1 ladder adds no round to the G2 ladder's.
//
// The point operations (pc_engine), over nj jobs at once, job j's
// accumulator p[j] and operand p[off + j], in place:
//   doubling (dbl-2009-l): D1 X^2, Y^2, Y Z; D2 B^2, (X + B)^2, (3A)^2;
//     D3 E (D - X3), with X3 = F - 2D and Z3 = 2 Y Z as its sums; D4 Y3 =
//     E (D - X3) - 8C: 3 product rounds and 1 sum round;
//   complete addition (add-1998-cmo-2 with the case analysis of the
//   plain curve.add): A1 Z1^2, Z2^2, Z1 Z2, Y1 Z2, Y2 Z1 (and the
//     infinity flags); A2 U1, U2, S1, S2 (H = U2 - U1, r = S2 - S1); A3 H^2,
//     Z1 Z2 H, r U1, r H, r^2, S1 H (and the flags H == 0, r == 0); A4 H^3,
//     U1 H^2, r U1 H^2, r H^3, r^3, S1 H^3; A5 the sums X3 = r^2 - H^3 - 2 U1
//     H^2, Y3 = 3 r U1 H^2 + r H^3 - r^3 - S1 H^3, Z3 = Z1 Z2 H, or the
//     exceptional result: an infinite operand gives the other, P == -Q
//     infinity, and P == Q leaves the job to a doubling that follows
//     (masked to those jobs), run only when a job needs it: 4 product
//     rounds and 1 sum round.
// Control flow depends only on the lane's weight bits (loaded by every
// thread) and on flags read from shared memory after a barrier, so it is
// uniform over the block and every thread reaches every barrier.
//
// Without __CUDACC__ the header compiles as plain C++ and lh_host_group
// runs each round's tasks one after another (forward, or backward), which
// emulates a block for a host harness.
#pragma once
#include "pair_coop.cuh"

struct pc_pt { fp2_t x, y, z; };                 // Jacobian, Z = 0 infinity

LH_DEV fp2_t& pt_co(pc_pt& p, int c) {
  return c == 0 ? p.x : (c == 1 ? p.y : p.z);
}

// A job's temporaries: the addition's A1-A3 products in 0..14, its A4
// products over the dead A1 slots 0..4 and in 15; the doubling's in 0..6.
enum {
  T_Z1Z1, T_Z2Z2, T_Z12, T_Y1Z2, T_Y2Z1, T_U1, T_U2, T_S1, T_S2, T_HH, T_Z3,
  T_RU1, T_RH, T_RR, T_S1H, T_S1H3, PC_NT
};
enum { T_H3, T_U1HH, T_RU1HH, T_RH3, T_R3 };
enum { T_A, T_B, T_YZ, T_C, T_TT, T_F, T_Y3A };

struct pc_job {
  fp2_t t[PC_NT];
  int inf1, inf2, h0, r0;
};

// The state of a block over J jobs: accumulators p[0, J), operands
// p[J, 2J); e[] the affine tail's values; flag the ladder's "runs" or the
// key sum's act.
template <int J>
struct pc_state {
  pc_pt p[2 * J];
  pc_job job[J];
  fp2_t e[6];
  int dbl_any, flag;
};
enum { E_ZI, E_ZI2, E_YZI, E_AX, E_AY, E_NRM };

// Round ids: the engine's below PC_PROG, a program's from PC_PROG on.
enum { E_D1, E_D2, E_D3, E_D4, E_A1, E_A2, E_A3, E_A4, E_A5, PC_PROG = 16 };

LH_DEV void f2_set_inf_co(fp_t& r, int c, int q) {   // (0, 1, 0)
  if (c == 1 && q == 0) r = LH_ONE; else set_zero(r);
}

template <int J>
struct pc_engine {
  pc_state<J>& s;
  int nj, off;
  bool fb;                           // a doubling after P == Q, masked

  LH_MEM pc_pt& p1(int j) { return s.p[j]; }
  LH_MEM pc_pt& p2(int j) { return s.p[off + j]; }
  LH_MEM bool doubles(int j) {
    const pc_job& b = s.job[j];
    return b.h0 && b.r0 && !b.inf1 && !b.inf2;
  }

  LH_MEM int start(int rid) {        // an operation over the same jobs
    fb = false;
    return rid;
  }

  LH_MEM int np(int rid) {
    switch (rid) {
      case E_D1: case E_D2: return 3 * nj;
      case E_D3: return nj;
      case E_A1: return 5 * nj;
      case E_A2: return 4 * nj;
      case E_A3: case E_A4: return 6 * nj;
      default: return 0;
    }
  }

  LH_MEM int nl(int rid) {
    switch (rid) {
      case E_D3: return 4 * nj;
      case E_D4: return 2 * nj;
      case E_A1: case E_A3: return nj;
      case E_A5: return 6 * nj;
      default: return 0;
    }
  }

  // H = U2 - U1 and r = S2 - S1 of job j.
  LH_MEM void hr(const fp2_t* t, fp2_t& h, fp2_t& r) {
    sub(h, t[T_U2], t[T_U1]);
    sub(r, t[T_S2], t[T_S1]);
  }

  LH_MEM fp2_t* pops(int rid, int k, fp2_t& a, fp2_t& b) {
    int per = rid == E_D1 || rid == E_D2 ? 3 :
              rid == E_D3 ? 1 : rid == E_A1 ? 5 : rid == E_A2 ? 4 : 6;
    const int j = k / per, u = k - per * j;
    fp2_t* t = s.job[j].t;
    pc_pt& P = p1(j);
    switch (rid) {
      case E_D1:
        a = u == 0 ? P.x : P.y;
        b = u == 0 ? P.x : (u == 1 ? P.y : P.z);
        return &t[T_A + u];
      case E_D2:
        if (u == 0) a = t[T_B];                      // C = B^2
        else if (u == 1) add(a, P.x, t[T_B]);        // (X + B)^2
        else f2_tri(a, t[T_A]);                      // F = (3A)^2
        b = a;
        return &t[T_C + u];
      case E_D3: {                                   // E (D - X3) = 3A (3D - F)
        fp2_t d, d3;
        sub(d, t[T_TT], t[T_A]);
        sub(d, d, t[T_C]);
        f2_dbl(d, d);
        f2_tri(d3, d);
        f2_tri(a, t[T_A]);
        sub(b, d3, t[T_F]);
        return &t[T_Y3A];
      }
      case E_A1: {
        const pc_pt& Q = p2(j);
        switch (u) {
          case 0: a = P.z; b = P.z; break;
          case 1: a = Q.z; b = Q.z; break;
          case 2: a = P.z; b = Q.z; break;
          case 3: a = P.y; b = Q.z; break;
          default: a = Q.y; b = P.z; break;
        }
        return &t[u];
      }
      case E_A2: {
        const pc_pt& Q = p2(j);
        switch (u) {
          case 0: a = P.x; b = t[T_Z2Z2]; break;     // U1
          case 1: a = Q.x; b = t[T_Z1Z1]; break;     // U2
          case 2: a = t[T_Y1Z2]; b = t[T_Z2Z2]; break;  // S1
          default: a = t[T_Y2Z1]; b = t[T_Z1Z1]; break;  // S2
        }
        return &t[T_U1 + u];
      }
      case E_A3: {
        fp2_t h, r;
        hr(t, h, r);
        switch (u) {
          case 0: a = h; b = h; return &t[T_HH];
          case 1: a = t[T_Z12]; b = h; return &t[T_Z3];
          case 2: a = r; b = t[T_U1]; return &t[T_RU1];
          case 3: a = r; b = h; return &t[T_RH];
          case 4: a = r; b = r; return &t[T_RR];
          default: a = t[T_S1]; b = h; return &t[T_S1H];
        }
      }
      default: {                                     // E_A4
        fp2_t h, r;
        hr(t, h, r);
        b = t[T_HH];
        switch (u) {
          case 0: a = h; return &t[T_H3];
          case 1: a = t[T_U1]; return &t[T_U1HH];
          case 2: a = t[T_RU1]; return &t[T_RU1HH];
          case 3: a = t[T_RH]; return &t[T_RH3];
          case 4: a = t[T_RR]; b = r; return &t[T_R3];
          default: a = t[T_S1H]; return &t[T_S1H3];
        }
      }
    }
  }

  LH_MEM void lin(int rid, int k) {
    switch (rid) {
      case E_D3: {                   // X3 = F - 2D, Z3 = 2 Y Z
        const int j = k >> 2, u = k & 3, q = u & 1;
        if (fb && !doubles(j)) return;
        const fp2_t* t = s.job[j].t;
        if (u < 2) {
          fp_t d;                    // 2D = 4 ((X + B)^2 - A - C)
          sub(d, co(t[T_TT], q), co(t[T_A], q));
          sub(d, d, co(t[T_C], q));
          add(d, d, d);
          add(d, d, d);
          sub(co(p1(j).x, q), co(t[T_F], q), d);
        } else {
          add(co(p1(j).z, q), co(t[T_YZ], q), co(t[T_YZ], q));
        }
        return;
      }
      case E_D4: {                   // Y3 = E (D - X3) - 8C
        const int j = k >> 1, q = k & 1;
        if (fb && !doubles(j)) return;
        const fp2_t* t = s.job[j].t;
        fp_t c8;
        add(c8, co(t[T_C], q), co(t[T_C], q));
        add(c8, c8, c8);
        add(c8, c8, c8);
        sub(co(p1(j).y, q), co(t[T_Y3A], q), c8);
        return;
      }
      case E_A1: {
        pc_job& b = s.job[k];
        b.inf1 = is_zero(p1(k).z);
        b.inf2 = is_zero(p2(k).z);
        if (k == 0) s.dbl_any = 0;
        return;
      }
      case E_A3: {
        pc_job& b = s.job[k];
        fp2_t h, r;
        hr(b.t, h, r);
        b.h0 = is_zero(h);
        b.r0 = is_zero(r);
        if (doubles(k)) s.dbl_any = 1;
        return;
      }
      default: {                     // E_A5: the result, in place
        const int j = k / 6, u = k - 6 * j, c = u >> 1, q = u & 1;
        const pc_job& b = s.job[j];
        const fp2_t* t = b.t;
        fp_t r, v;
        if (b.inf1) {
          r = co(pt_co(p2(j), c), q);
        } else if (b.inf2 || (b.h0 && b.r0)) {
          return;                    // P, or P == Q: doubled next
        } else if (b.h0) {
          f2_set_inf_co(r, c, q);    // P == -Q
        } else if (c == 0) {         // r^2 - H^3 - 2 U1 H^2
          sub(r, co(t[T_RR], q), co(t[T_H3], q));
          sub(r, r, co(t[T_U1HH], q));
          sub(r, r, co(t[T_U1HH], q));
        } else if (c == 1) {         // 3 r U1 H^2 + r H^3 - r^3 - S1 H^3
          add(v, co(t[T_RU1HH], q), co(t[T_RU1HH], q));
          add(r, v, co(t[T_RU1HH], q));
          add(r, r, co(t[T_RH3], q));
          sub(r, r, co(t[T_R3], q));
          sub(r, r, co(t[T_S1H3], q));
        } else {
          r = co(t[T_Z3], q);
        }
        co(pt_co(p1(j), c), q) = r;
        return;
      }
    }
  }
};

// Program rounds.
enum {
  L_LOAD = PC_PROG, L_INV, L_AF1, L_AF2, L_OUT,
  R_INIT, R_LOAD, R_OPND, R_NORM, R_INV, R_ZI, R_AF1, R_AF2, R_OUT
};

// The affine tail's products: 1/Z in E_ZI; zi^2 and Y zi, then X zi^2 and
// (Y zi) zi^2.
template <int J>
LH_DEV fp2_t* pc_affine_ops(pc_state<J>& s, int stage, int k, fp2_t& a,
                            fp2_t& b) {
  fp2_t* e = s.e;
  if (stage == 0) {
    a = k ? s.p[0].y : e[E_ZI];
    b = e[E_ZI];
    return k ? &e[E_YZI] : &e[E_ZI2];
  }
  a = k ? e[E_YZI] : s.p[0].x;
  b = e[E_ZI2];
  return k ? &e[E_AY] : &e[E_AX];
}

// One lane of k_points: [r] P (G1, job 0) and [r] sig (G2, job 1), MSB
// first from the weight's top bit (acc = base there), then P's affine
// words by one binary-Euclid inverse.  P is affine (xp, yp, pinf) or, in
// the mask variant, Jacobian at pk_jac (36 words) with the set's act flag;
// an inactive set's signature counts as infinity and its winf is set.
// Out: wx, wy (12 words), winf, and [r] sig in Jacobian words at ws (72).
struct pc_ladder {
  pc_engine<2> e;
  const uint32_t *xp, *yp;
  bool pinf;
  const uint32_t* pk_jac;
  bool active;
  const uint32_t *xs, *ys;
  bool sinf;
  uint64_t r;
  uint32_t *wx, *wy;
  uint8_t* winf;
  uint32_t* ws;
  int bit;

  LH_MEM int first() {
    e.nj = 2;
    e.off = 2;
    e.fb = false;
    return L_LOAD;
  }

  LH_MEM int step() {
    if (bit == 0) return is_zero(e.s.p[0].z) ? L_OUT : L_INV;
    bit--;
    return e.start(E_D1);
  }

  LH_MEM int next(int rid) {
    switch (rid) {
      case L_LOAD:
        if (!e.s.flag) return L_OUT;
        bit = 63;
        while (!((r >> bit) & 1)) bit--;
        return step();
      case E_D4:
        if (e.fb || !((r >> bit) & 1)) return step();
        return e.start(E_A1);
      case E_A5:
        if (e.s.dbl_any) {
          e.fb = true;
          return E_D1;
        }
        return step();
      case L_OUT: return -1;
      default: return rid + 1;       // the engine's rounds, L_INV..L_AF2
    }
  }

  LH_MEM int np(int rid) {
    if (rid < PC_PROG) return e.np(rid);
    return rid == L_AF1 || rid == L_AF2 ? 2 : 0;
  }

  LH_MEM int nl(int rid) {
    if (rid < PC_PROG) return e.nl(rid);
    switch (rid) {
      case L_LOAD: return 13;
      case L_INV: return 1;
      case L_OUT: return 9;
      default: return 0;
    }
  }

  LH_MEM fp2_t* pops(int rid, int k, fp2_t& a, fp2_t& b) {
    if (rid < PC_PROG) return e.pops(rid, k, a, b);
    return pc_affine_ops(e.s, rid - L_AF1, k, a, b);
  }

  // Coordinate (c, q) of the base of group g.
  LH_MEM void base_co(fp_t& v, int g, int c, int q) {
    if (g == 0) {
      if (q) {
        set_zero(v);
      } else if (pk_jac) {
        load(v, pk_jac + 12 * c);
      } else if (c < 2) {
        load(v, c ? yp : xp);
      } else if (pinf) {
        set_zero(v);
      } else {
        v = LH_ONE;
      }
    } else if (c < 2) {
      load(v, (c ? ys : xs) + 12 * q);
    } else if (q || sinf || !active) {
      set_zero(v);
    } else {
      v = LH_ONE;
    }
  }

  LH_MEM void lin(int rid, int k) {
    if (rid < PC_PROG) {
      e.lin(rid, k);
      return;
    }
    pc_state<2>& s = e.s;
    switch (rid) {
      case L_LOAD: {
        if (k == 12) {               // run unless r == 0 or both infinite
          fp_t z;
          base_co(z, 0, 2, 0);
          s.flag = r != 0 && !(is_zero(z) && (sinf || !active));
          return;
        }
        const int g = k / 6, u = k - 6 * g, c = u >> 1, q = u & 1;
        fp_t v;
        base_co(v, g, c, q);
        co(pt_co(s.p[2 + g], c), q) = v;
        if (r == 0) f2_set_inf_co(v, c, q);
        co(pt_co(s.p[g], c), q) = v;
        return;
      }
      case L_INV:
        fp_inv_vt(s.e[E_ZI].c0, s.p[0].z.c0);
        set_zero(s.e[E_ZI].c1);
        return;
      default: {                     // L_OUT
        if (k < 3) {
          const bool inf = is_zero(s.p[0].z);
          if (k == 2) {
            *winf = (inf || !active) ? 1 : 0;
            return;
          }
          fp_t v = s.e[k ? E_AY : E_AX].c0;
          if (inf) set_zero(v);
          store(k ? wy : wx, v);
          return;
        }
        const int u = k - 3, c = u >> 1, q = u & 1;
        store(ws + 24 * c + 12 * q, co(pt_co(s.p[1], c), q));
        return;
      }
    }
  }
};

// One block's sum of points over J accumulators: the first J points load
// into them, each further J are added to them (operands p[J + j]), then a
// halving tree adds accumulator j + ceil(w / 2) into j.  Three sources:
//   g1 (the mask variant's key sums, launch 1): the set's k keys at xpk,
//     ypk (affine, 12 words), a key counting where mask and not ipk; out
//     the Jacobian sum at pk_jac (36 words) and act = any mask bit set;
//   G2 (the signature sum, launch 3): n Jacobian points at ws (72 words
//     each), src_y null;
//   G2 affine (k_ring.cu's k_ring_sum): n points at src_x, src_y (24 words
//     each), infinity where ipk is set (loaded as (0, 1, 0), whatever x
//     and y hold);
// a G2 source's out is the affine sum at sx, sy (24 words each) and ssinf,
// by the norm's inverse (one binary Euclid) and conj(Z).
template <int J>
struct pc_reduce {
  pc_engine<J> e;
  bool g1;
  const uint32_t *src_x, *src_y;     // g1: xpk, ypk; G2: ws, or x, y
  const uint8_t *ipk, *mask;         // G2 affine: ipk = the inf flags
  int n;                             // keys, or points
  uint32_t *out_x, *out_y;           // g1: pk_jac; G2: sx, sy
  uint8_t* out_f;                    // g1: act; G2: ssinf
  int base, w, h;
  bool tree;

  LH_MEM int first() {
    e.fb = false;
    return g1 ? R_INIT : R_LOAD;
  }

  LH_MEM int stream() {
    if (base < n) return R_OPND;
    tree = true;
    w = n < J ? n : J;
    return level();
  }

  LH_MEM int level() {
    if (w > 1) {
      h = (w + 1) >> 1;
      e.nj = w - h;
      e.off = h;
      return e.start(E_A1);
    }
    if (g1 || is_zero(e.s.p[0].z)) return R_OUT;
    return R_NORM;
  }

  LH_MEM int op_done() {
    if (tree) {
      w = h;
      return level();
    }
    base += J;
    return stream();
  }

  LH_MEM int next(int rid) {
    switch (rid) {
      case R_LOAD:
        base = J;
        tree = false;
        return stream();
      case R_OPND:
        e.nj = J;
        e.off = J;
        return e.start(E_A1);
      case E_D4: return op_done();   // only after P == Q
      case E_A5:
        if (e.s.dbl_any) {
          e.fb = true;
          return E_D1;
        }
        return op_done();
      case R_OUT: return -1;
      default: return rid + 1;       // engine rounds, R_INIT, R_NORM..R_AF2
    }
  }

  LH_MEM int np(int rid) {
    if (rid < PC_PROG) return e.np(rid);
    switch (rid) {
      case R_NORM: case R_ZI: return 1;
      case R_AF1: case R_AF2: return 2;
      default: return 0;
    }
  }

  LH_MEM int nl(int rid) {
    if (rid < PC_PROG) return e.nl(rid);
    switch (rid) {
      case R_INIT: case R_INV: return 1;
      case R_LOAD: case R_OPND: return 6 * J;
      case R_OUT: return g1 ? 4 : 5;
      default: return 0;
    }
  }

  LH_MEM fp2_t* pops(int rid, int k, fp2_t& a, fp2_t& b) {
    if (rid < PC_PROG) return e.pops(rid, k, a, b);
    pc_state<J>& s = e.s;
    switch (rid) {
      case R_NORM:                   // N = Z conj(Z), in c0
        a = s.p[0].z;
        conj(b, s.p[0].z);
        return &s.e[E_NRM];
      case R_ZI:                     // 1/Z = conj(Z) / N
        conj(a, s.p[0].z);
        b = s.e[E_ZI];
        return &s.e[E_ZI];
      default: return pc_affine_ops(s, rid - R_AF1, k, a, b);
    }
  }

  // Point i of the source into p[slot], coordinate (c, q); infinity past
  // the end or where the mask drops a key.
  LH_MEM void load_co(int slot, int i, int c, int q) {
    pc_state<J>& s = e.s;
    fp_t v;
    if (g1) {
      const bool in = i < n && mask[i];
      if (in && c == 0 && q == 0) s.flag = 1;   // the set's act
      if (!in || ipk[i]) {
        f2_set_inf_co(v, c, q);
      } else if (q) {
        set_zero(v);
      } else if (c < 2) {
        load(v, (c ? src_y : src_x) + 12 * (size_t)i);
      } else {
        v = LH_ONE;
      }
    } else if (i >= n || (src_y && ipk[i])) {
      f2_set_inf_co(v, c, q);
    } else if (!src_y) {
      load(v, src_x + 72 * (size_t)i + 24 * c + 12 * q);
    } else if (c < 2) {
      load(v, (c ? src_y : src_x) + 24 * (size_t)i + 12 * q);
    } else if (q) {
      set_zero(v);
    } else {
      v = LH_ONE;
    }
    co(pt_co(s.p[slot], c), q) = v;
  }

  LH_MEM void lin(int rid, int k) {
    if (rid < PC_PROG) {
      e.lin(rid, k);
      return;
    }
    pc_state<J>& s = e.s;
    const int j = k / 6, u = k - 6 * j;
    switch (rid) {
      case R_INIT: s.flag = 0; return;
      case R_LOAD: load_co(j, j, u >> 1, u & 1); return;
      case R_OPND: load_co(J + j, base + j, u >> 1, u & 1); return;
      case R_INV:
        fp_inv_vt(s.e[E_ZI].c0, s.e[E_NRM].c0);
        set_zero(s.e[E_ZI].c1);
        return;
      default: {                     // R_OUT
        if (g1) {
          if (k < 3) store(out_x + 12 * k, pt_co(s.p[0], k).c0);
          else *out_f = s.flag ? 1 : 0;
          return;
        }
        const bool inf = is_zero(s.p[0].z);
        if (k == 4) {
          *out_f = inf ? 1 : 0;
          return;
        }
        fp_t v = co(s.e[k < 2 ? E_AX : E_AY], k & 1);
        if (inf) set_zero(v);
        store((k < 2 ? out_x : out_y) + 12 * (k & 1), v);
        return;
      }
    }
  }
};
