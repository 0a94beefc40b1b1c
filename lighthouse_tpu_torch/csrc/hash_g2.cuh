// Hash to G2 and the signing ladder on a lane machine, for k_hash and
// k_sign (k_sign_root, k_sign_field).
//
// Two threads a message.  Adjacent threads of a warp each map one field
// element (the even thread u0, the odd u1) by RFC 9380's straight-line
// simplified SWU (Appendix F.2: x kept as xn / xd, y affine from
// sqrt_ratio, whose q = p^2 = 9 (mod 16) case is one Fp2 exponentiation by
// (q - 9) / 16 and a fixed sequence of products and selects) and evaluate
// the 3-isogeny on (xn, xd, y) straight into Jacobian coordinates, with no
// inversion.  The pair swaps its two points through shared memory; both
// threads then run the same complete sum and Budroni-Pintore cofactor
// clearing, [x^2 - x - 1] P + [x - 1] psi(P) + psi^2([2] P), on the same
// data.  k_hash ends with one variable-time inversion (binary Euclid of
// fp_ptx.cuh, outside the machine: lh_invert_norm) for the affine point.
// k_sign splits [k] H over the pair by psi = [z] on G2 (z = -|z|):
// k mod r = d0 + d1 |z| + d2 |z|^2 + d3 |z|^3
// with d_i < |z| < 2^64 (r < |z|^4), so
//   [k] H = d0 H + d1 (-psi H) + d2 psi^2 H + d3 (-psi^3 H);
// the even thread runs the joint 64-step ladder of (d0, d1) over the table
// {inf, H, -psi H, H - psi H}, the odd one (d2, d3) over {inf, psi^2 H,
// -psi^3 H, psi^2 H - psi^3 H}, the 2T of each entry stored beside it, and
// one complete addition joins the halves before the compression (Fermat,
// no branch on the point).
//
// The machine.  Each thread owns NS Fp2 slots in shared memory (slot k,
// word w of thread t at ((k * 24 + w) * nt + t): a warp's accesses are 32
// consecutive words).  A program is a script of routines; a routine is a
// list of Fp2 operations on slots (lh_op: kind, destination, operands),
// and the script runs routines once, over the bits of a public exponent
// (square every bit, multiply where it is set), over the 4-bit sliding
// windows of sqrt_ratio's exponent (a table of 8 odd powers in the point
// slots, free until the isogeny), or over the 64 steps of the ladder.
// Every operation goes through one execution site (lh_vm::exec), so each
// field operation is compiled once a kernel, nothing is __noinline__ and
// nothing needs a stack.  Control flow depends only on
// the script and its public constants: uniform over a warp.  Selects are
// word masks under flags (bits of a register: is zero, equal to a
// constant, sgn0), and the ladder reads all three table entries under
// masks, so no branch, early exit or table index depends on a secret
// scalar or on anything computed from it; the scalar's digits come from a
// masked subtraction of r and fixed shift-and-subtract divisions by |z|.
// A thread past the last message runs message 0's data and stores nothing.
//
// Without __CUDACC__ the header compiles as plain C++: lh_vm::run stops at
// each swap point (V_SYNC), so a host harness runs a pair's two machines in
// turn over one slot array (nt = 2).
#pragma once
#include "fp_ptx.cuh"

#ifdef __CUDACC__
#define LH_MEM __device__ __forceinline__
#else
#define LH_MEM inline
#endif

// ------------------------------------------------------------ slots -----

// Points take three consecutive slots (x, y, z).
enum {
  PA = 0, PB = 3, PD = 6,                 // operands of the point routines
  T0 = 9, T1, T2, T3, T4, T5, T6, T7,     // temporaries
  QP = 17,                                // a map's point, then their sum
  Q1P = 20, Q2P = 23, QACC = 26,          // cofactor clearing
  LH_HASH_SLOTS = 29,
  TE = 17,                                // ladder table: E1, E2, E3, then
  TD = 26,                                // D1 = 2 E1, D2, D3
  LH_SIGN_SLOTS = 35,
};
// The map's names for slots 0..16 (before any point routine runs).
enum {
  MU = 0, M1, M2, M3, M4, M5, M6, MX, MY,  // u, RFC tv1..tv6, x, y
  R1 = 9, R2, R3, R4, R5, RB,              // sqrt_ratio tv1..tv5, pow base
};

// Constants (lh_vm::konst).
enum {
  K_ZERO, K_ONE, K_RAW1, K_A, K_B, K_Z, K_C6, K_C7, K_PSIX, K_PSIY,
  K_ISO,                                   // 16: LH_ISO[p][k] at 4 p + k
};

// Flags: bit i of lh_vm::fl; an operand 0x80 | i reads its negation.
enum { F_U, F_ODD, F_0, F_1, F_2, F_3, F_H, F_R, F_A, F_T, F_DD, F_NI };
#define NF(f) (0x80 | (f))

// ------------------------------------------------------------ ops -------

enum {
  V_MUL,    // d = a b
  V_MULK,   // d = a K[b]
  V_SQR,    // d = a^2
  V_ADD,    // d = a + b
  V_ADDK,   // d = a + K[b]
  V_SUB,    // d = a - b
  V_NEG,    // d = -a
  V_CONJ,   // d = conj(a)
  V_COPY,   // d = a
  V_LDK,    // d = K[a]
  V_CMOV,   // d = flag b ? a : d
  V_CMOVK,  // d = flag b ? K[a] : d
  V_EQK,    // flag d = (a == K[b])
  V_ISZ,    // flag d = (a == 0)
  V_FAND,   // flag d = flag a & flag b
  V_SGN,    // flag d = sgn0(a, a plain value) ^ flag b
  V_FSQR,   // d = (a.c0^2, 0)
  V_FMUL,   // d = (a.c0 b.c0, 0)
  V_PAIR,   // d = slot a of the pair's thread b (0 even, 1 odd)
  V_MULW,   // d = a slot[window], the script's current odd power
  V_TSEL,   // point d = the ladder table entry at a (b = 0) or its double
            // (b = 1) for this step's digit bits; infinity for bits 00
  V_SYNC,   // stop: the pair's threads meet (__syncwarp)
  V_RET,    // end of the routine
  V_END,    // end of the script
};
struct lh_op { uint8_t k, d, a, b; };
#define OP(k, d, a, b) {V_##k, (uint8_t)(d), (uint8_t)(a), (uint8_t)(b)}
#define RET {V_RET, 0, 0, 0}

// ------------------------------------------------------------ routines --

// RFC 9380 F.2 map_to_curve_simple_swu up to sqrt_ratio(tv2, tv6) step 5
// (tv5 = u v^15 ready to raise to c3, and copied as the power's base).
LH_CONST lh_op LH_R_SSWU[] = {
    OP(SQR, M1, MU, 0),        // tv1 = u^2
    OP(MULK, M1, M1, K_Z),     // tv1 = Z tv1
    OP(SQR, M2, M1, 0),        // tv2 = tv1^2
    OP(ADD, M2, M2, M1),       // tv2 = tv2 + tv1
    OP(ADDK, M3, M2, K_ONE),   // tv3 = tv2 + 1
    OP(MULK, M3, M3, K_B),     // tv3 = B tv3
    OP(NEG, M4, M2, 0),
    OP(ISZ, F_0, M2, 0),
    OP(CMOVK, M4, K_Z, F_0),   // tv4 = CMOV(Z, -tv2, tv2 != 0)
    OP(MULK, M4, M4, K_A),     // tv4 = A tv4
    OP(SQR, M2, M3, 0),        // tv2 = tv3^2
    OP(SQR, M6, M4, 0),        // tv6 = tv4^2
    OP(MULK, M5, M6, K_A),     // tv5 = A tv6
    OP(ADD, M2, M2, M5),       // tv2 = tv2 + tv5
    OP(MUL, M2, M2, M3),       // tv2 = tv2 tv3
    OP(MUL, M6, M6, M4),       // tv6 = tv6 tv4
    OP(MULK, M5, M6, K_B),     // tv5 = B tv6
    OP(ADD, M2, M2, M5),       // tv2 = tv2 + tv5
    OP(MUL, MX, M1, M3),       // x = tv1 tv3
    // sqrt_ratio(u' = tv2, v' = tv6), F.2.1.1 with c1 = 3
    OP(LDK, R1, K_C6, 0),      // tv1 = c6
    OP(SQR, R2, M6, 0),
    OP(MUL, R2, R2, M6),
    OP(SQR, R2, R2, 0),
    OP(MUL, R2, R2, M6),       // tv2 = v^7
    OP(SQR, R3, R2, 0),
    OP(MUL, R3, R3, M6),       // tv3 = tv2^2 v
    OP(MUL, R5, M2, R3),       // tv5 = u tv3
    OP(COPY, RB, R5, 0),
    RET,
};
LH_CONST lh_op LH_R_PSQR[] = {OP(SQR, R5, R5, 0), RET};
// The 4-bit window table of the power: x^(2i + 1) at slot WT + i (the
// point slots are free until the isogeny), and the accumulator R5 = 1.
enum { WT = 17 };
LH_CONST lh_op LH_R_WTAB[] = {
    OP(COPY, WT, RB, 0), OP(SQR, 15, RB, 0),
    OP(MUL, WT + 1, WT, 15), OP(MUL, WT + 2, WT + 1, 15),
    OP(MUL, WT + 3, WT + 2, 15), OP(MUL, WT + 4, WT + 3, 15),
    OP(MUL, WT + 5, WT + 4, 15), OP(MUL, WT + 6, WT + 5, 15),
    OP(MUL, WT + 7, WT + 6, 15), OP(LDK, R5, K_ONE, 0), RET};
LH_CONST lh_op LH_R_WMUL[] = {OP(MULW, R5, R5, 0), RET};
// sqrt_ratio from step 7 (tv5 = tv5^c3 done), then map steps 19-24.
LH_CONST lh_op LH_R_SQRT[] = {
    OP(MUL, R5, R5, R2),       // tv5 = tv5 tv2
    OP(MUL, R2, R5, M6),       // tv2 = tv5 v
    OP(MUL, R3, R5, M2),       // tv3 = tv5 u
    OP(MUL, R4, R3, R2),       // tv4 = tv3 tv2
    OP(SQR, R5, R4, 0),
    OP(SQR, R5, R5, 0),        // tv5 = tv4^4
    OP(EQK, F_1, R5, K_ONE),   // isQR
    OP(MULK, R2, R3, K_C7),    // tv2 = tv3 c7
    OP(MUL, R5, R4, R1),       // tv5 = tv4 tv1
    OP(CMOV, R3, R2, NF(F_1)), // tv3 = CMOV(tv2, tv3, isQR)
    OP(CMOV, R4, R5, NF(F_1)), // tv4 = CMOV(tv5, tv4, isQR)
    OP(SQR, R5, R4, 0),        // i = 3: tv5 = tv4^2
    OP(EQK, F_2, R5, K_ONE),
    OP(MUL, R2, R3, R1),
    OP(SQR, R1, R1, 0),
    OP(MUL, R5, R4, R1),
    OP(CMOV, R3, R2, NF(F_2)),
    OP(CMOV, R4, R5, NF(F_2)),
    OP(EQK, F_2, R4, K_ONE),   // i = 2: tv5 = tv4
    OP(MUL, R2, R3, R1),
    OP(CMOV, R3, R2, NF(F_2)), // y1 = tv3 (tv4 is not needed again)
    OP(MUL, MY, M1, MU),       // y = tv1 u
    OP(MUL, MY, MY, R3),       // y = y y1
    OP(CMOV, MX, M3, F_1),     // x = CMOV(x, tv3, isQR)
    OP(CMOV, MY, R3, F_1),     // y = CMOV(y, y1, isQR)
    OP(MULK, R5, MY, K_RAW1),  // y off Montgomery form
    OP(SGN, F_3, R5, F_U),     // sgn0(y) != sgn0(u)
    OP(NEG, R5, MY, 0),
    OP(CMOV, MY, R5, F_3),     // y = CMOV(-y, y, e1)
    RET,
};
// The 3-isogeny on x = xn / xd (xn = MX, xd = tv4), y: the four maps as
// cubic forms in (xn, xd) -- the padded LH_ISO makes XDEN's xd XDEN(xn,
// xd) -- and the point (XN XD YD^2, y YN XD^3 YD^2, XD YD) at QP.
LH_CONST lh_op LH_R_ISO[] = {
    OP(SQR, 0, MX, 0),         // xn^2
    OP(MUL, 1, 0, MX),         // xn^3
    OP(SQR, 2, M4, 0),         // xd^2
    OP(MUL, 3, 2, M4),         // xd^3
    OP(MUL, 5, 0, M4),         // xn^2 xd
    OP(MUL, 6, MX, 2),         // xn xd^2
#define LH_ISO_FORM(p)                                                    \
    OP(MULK, 9 + p, 1, K_ISO + 4 * p + 3),                                \
    OP(MULK, 13, 5, K_ISO + 4 * p + 2), OP(ADD, 9 + p, 9 + p, 13),        \
    OP(MULK, 13, 6, K_ISO + 4 * p + 1), OP(ADD, 9 + p, 9 + p, 13),        \
    OP(MULK, 13, 3, K_ISO + 4 * p), OP(ADD, 9 + p, 9 + p, 13)
    LH_ISO_FORM(0), LH_ISO_FORM(1), LH_ISO_FORM(2), LH_ISO_FORM(3),
#undef LH_ISO_FORM
    OP(MUL, QP + 2, 10, 12),   // Z = XD YD
    OP(SQR, 14, 12, 0),        // YD^2
    OP(MUL, 13, 9, 10),
    OP(MUL, QP, 13, 14),       // X = XN XD YD^2
    OP(SQR, 15, 10, 0),
    OP(MUL, 15, 15, 10),       // XD^3
    OP(MUL, 13, MY, 11),
    OP(MUL, 13, 13, 15),
    OP(MUL, QP + 1, 13, 14),   // Y = y YN XD^3 YD^2
    RET,
};

// dbl-2009-l (a = 0): point dst = 2 src through T0..T7 (dst may be src;
// infinity stays infinity, Z3 = 2 Y Z = 0).
#define LH_DBL(s, dd)                                                     \
    OP(SQR, T0, s, 0), OP(SQR, T1, s + 1, 0), OP(SQR, T2, T1, 0),         \
    OP(ADD, T3, s, T1), OP(SQR, T3, T3, 0), OP(SUB, T3, T3, T0),          \
    OP(SUB, T3, T3, T2), OP(ADD, T3, T3, T3),        /* D */              \
    OP(ADD, T4, T0, T0), OP(ADD, T4, T4, T0),        /* E = 3A */         \
    OP(SQR, T5, T4, 0), OP(ADD, T6, T3, T3),                              \
    OP(SUB, T5, T5, T6),                             /* X3 */             \
    OP(SUB, T6, T3, T5), OP(MUL, T6, T4, T6), OP(ADD, T2, T2, T2),        \
    OP(ADD, T2, T2, T2), OP(ADD, T2, T2, T2),                             \
    OP(SUB, T6, T6, T2),                             /* Y3 */             \
    OP(MUL, T7, s + 1, s + 2), OP(ADD, T7, T7, T7),  /* Z3 */             \
    OP(COPY, dd, T5, 0), OP(COPY, dd + 1, T6, 0), OP(COPY, dd + 2, T7, 0)
LH_CONST lh_op LH_R_DBLA[] = {LH_DBL(PA, PA), RET};   // PA = 2 PA
LH_CONST lh_op LH_R_DBLB[] = {LH_DBL(PB, PD), RET};   // PD = 2 PB

// PA = PA + PB, complete, given PD = 2 PB: add-2007-bl, then by masks, each
// over the last, 2 PB where PA == PB, infinity where PA == -PB, PB where PA
// is infinity and PA where PB is.
LH_CONST lh_op LH_R_ADD[] = {
    OP(ISZ, F_A, PA + 2, 0),
    OP(ISZ, F_T, PB + 2, 0),
    OP(SQR, T0, PA + 2, 0),    // Z1Z1
    OP(SQR, T1, PB + 2, 0),    // Z2Z2
    OP(MUL, T2, PA, T1),       // U1
    OP(MUL, T3, PB, T0),       // U2
    OP(MUL, T4, PA + 1, PB + 2),
    OP(MUL, T4, T4, T1),       // S1
    OP(MUL, T5, PB + 1, PA + 2),
    OP(MUL, T5, T5, T0),       // S2
    OP(SUB, T3, T3, T2),       // H
    OP(SUB, T5, T5, T4),       // S2 - S1
    OP(ISZ, F_H, T3, 0),
    OP(ISZ, F_R, T5, 0),
    OP(ADD, T5, T5, T5),       // r
    OP(ADD, T6, T3, T3),
    OP(SQR, T6, T6, 0),        // I = (2H)^2
    OP(MUL, T7, T3, T6),       // J
    OP(MUL, T6, T2, T6),       // V
    OP(SQR, T2, T5, 0),
    OP(SUB, T2, T2, T7),
    OP(SUB, T2, T2, T6),
    OP(SUB, T2, T2, T6),       // X3 = r^2 - J - 2V
    OP(SUB, T6, T6, T2),
    OP(MUL, T6, T5, T6),
    OP(MUL, T4, T4, T7),
    OP(ADD, T4, T4, T4),
    OP(SUB, T6, T6, T4),       // Y3 = r (V - X3) - 2 S1 J
    OP(ADD, T4, PA + 2, PB + 2),
    OP(SQR, T4, T4, 0),
    OP(SUB, T4, T4, T0),
    OP(SUB, T4, T4, T1),
    OP(MUL, T4, T4, T3),       // Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H
    OP(FAND, F_DD, F_H, F_R),
    OP(FAND, F_NI, F_H, NF(F_R)),
    OP(CMOV, T2, PD, F_DD),
    OP(CMOV, T6, PD + 1, F_DD),
    OP(CMOV, T4, PD + 2, F_DD),
    OP(CMOVK, T2, K_ZERO, F_NI),
    OP(CMOVK, T6, K_ONE, F_NI),
    OP(CMOVK, T4, K_ZERO, F_NI),
    OP(CMOV, T2, PB, F_A),
    OP(CMOV, T6, PB + 1, F_A),
    OP(CMOV, T4, PB + 2, F_A),
    OP(CMOV, T2, PA, F_T),
    OP(CMOV, T6, PA + 1, F_T),
    OP(CMOV, T4, PA + 2, F_T),
    OP(COPY, PA, T2, 0),
    OP(COPY, PA + 1, T6, 0),
    OP(COPY, PA + 2, T4, 0),
    RET,
};

#define LH_MOV(d, s) OP(COPY, d, s, 0), OP(COPY, d + 1, s + 1, 0),       \
    OP(COPY, d + 2, s + 2, 0)
#define LH_NEGP(d, s) OP(COPY, d, s, 0), OP(NEG, d + 1, s + 1, 0),       \
    OP(COPY, d + 2, s + 2, 0)
#define LH_PSI(d, s) OP(CONJ, d, s, 0), OP(MULK, d, d, K_PSIX),          \
    OP(CONJ, d + 1, s + 1, 0), OP(MULK, d + 1, d + 1, K_PSIY),            \
    OP(CONJ, d + 2, s + 2, 0)
#define LH_PAIR(d, s, b) OP(PAIR, d, s, b), OP(PAIR, d + 1, s + 1, b),   \
    OP(PAIR, d + 2, s + 2, b)

// The pair's two map points: PA = the even thread's, PB = the odd one's.
LH_CONST lh_op LH_R_SWAP[] = {
    {V_SYNC, 0, 0, 0}, LH_PAIR(PA, QP, 0), LH_PAIR(PB, QP, 1),
    {V_SYNC, 0, 0, 0}, RET};
// P = QP = their sum, and PA = PB = P: the |x| ladder's start and base.
LH_CONST lh_op LH_R_SUM[] = {LH_MOV(QP, PA), LH_MOV(PB, QP), LH_MOV(PA, PB),
                             RET};
// Cofactor clearing on P = QP: t1 = [x] P, t2 = [x] t1 by ladders over |x|
// (the top bit set: acc starts at the base), then the Budroni-Pintore sum.
LH_CONST lh_op LH_R_CC0[] = {LH_NEGP(Q1P, PA), LH_MOV(PB, Q1P), RET};
LH_CONST lh_op LH_R_CC1[] = {LH_MOV(PA, PB), RET};
LH_CONST lh_op LH_R_CC2[] = {LH_NEGP(Q2P, PA), LH_MOV(PA, Q2P),
                             LH_NEGP(PB, Q1P), RET};       // t2 - t1
LH_CONST lh_op LH_R_CC3[] = {LH_NEGP(PB, QP), RET};        // ... - P
LH_CONST lh_op LH_R_CC4[] = {LH_MOV(QACC, PA), LH_MOV(PA, Q1P),
                             LH_NEGP(PB, QP), RET};        // t1 - P
LH_CONST lh_op LH_R_CC5[] = {LH_PSI(PB, PA), LH_MOV(PA, QACC), RET};
LH_CONST lh_op LH_R_CC6[] = {LH_MOV(QACC, PA), LH_MOV(PA, QP), RET};
LH_CONST lh_op LH_R_CC7[] = {LH_PSI(PB, PA), LH_PSI(PB, PB),
                             LH_MOV(PA, QACC), RET};       // + psi^2(2P)
// k_hash: the affine point (T4, T5) of PA, around the inverse of the norm
// N = Z conj(Z) (in T0's c0), which the kernel takes between the two
// scripts (lh_invert_norm).
LH_CONST lh_op LH_R_AFF0[] = {
    OP(CONJ, T1, PA + 2, 0), OP(MUL, T0, PA + 2, T1), RET};
LH_CONST lh_op LH_R_AFF1[] = {
    OP(MUL, T1, T1, T0),       // 1/Z = conj(Z) / N
    OP(SQR, T2, T1, 0),
    OP(MUL, T3, T2, T1),
    OP(MUL, T4, PA, T2),
    OP(MUL, T5, PA + 1, T3),
    RET,
};
// k_sign: the table.  S = H on the even thread, psi^2 H on the odd one;
// E1 = S, E2 = -psi S, E3 = E1 + E2, D_i = 2 E_i.
LH_CONST lh_op LH_R_TAB0[] = {
    LH_PSI(PB, PA), LH_PSI(PB, PB),
    OP(CMOV, PA, PB, F_ODD), OP(CMOV, PA + 1, PB + 1, F_ODD),
    OP(CMOV, PA + 2, PB + 2, F_ODD),
    LH_MOV(TE, PA), LH_PSI(PB, PA), OP(NEG, PB + 1, PB + 1, 0),
    LH_MOV(TE + 3, PB), RET};
LH_CONST lh_op LH_R_TAB1[] = {LH_MOV(TE + 6, PA), LH_MOV(TD + 3, PD),
                              LH_MOV(PA, TE), RET};
LH_CONST lh_op LH_R_TAB2[] = {LH_MOV(TD, PA), LH_MOV(PA, TE + 6), RET};
LH_CONST lh_op LH_R_TAB3[] = {LH_MOV(TD + 6, PA), OP(LDK, PA, K_ZERO, 0),
                              OP(LDK, PA + 1, K_ONE, 0),
                              OP(LDK, PA + 2, K_ZERO, 0), RET};
// One ladder step after the doubling: PB = T, PD = 2 T.
LH_CONST lh_op LH_R_SEL[] = {OP(TSEL, PB, TE, 0), OP(TSEL, PD, TE, 1), RET};
// The join: PA = the even thread's half, PB = the odd one's.
LH_CONST lh_op LH_R_JOIN[] = {
    {V_SYNC, 0, 0, 0}, LH_PAIR(PD, PA, 0), LH_PAIR(PB, PA, 1),
    {V_SYNC, 0, 0, 0}, LH_MOV(PA, PD), RET};
// g2_compress: 1/Z = conj(Z) N^(p - 2), N = Z conj(Z), Fermat on N (the
// power runs in T1 from base T0).
LH_CONST lh_op LH_R_CMP0[] = {
    OP(CONJ, T2, PA + 2, 0), OP(MUL, T0, PA + 2, T2), OP(COPY, T1, T0, 0),
    RET};
LH_CONST lh_op LH_R_FSQR[] = {OP(FSQR, T1, T1, 0), RET};
LH_CONST lh_op LH_R_FMUL[] = {OP(FMUL, T1, T1, T0), RET};
LH_CONST lh_op LH_R_CMP1[] = {
    OP(MUL, T2, T2, T1),       // 1/Z
    OP(SQR, T3, T2, 0),
    OP(MUL, T4, T3, T2),
    OP(MUL, T5, PA, T3),
    OP(MUL, T6, PA + 1, T4),
    OP(MULK, T5, T5, K_RAW1),  // x, y off Montgomery form
    OP(MULK, T6, T6, K_RAW1),
    RET,
};

enum {
  R_SSWU, R_PSQR, R_SQRT, R_ISO, R_DBLA, R_DBLB, R_ADD, R_SWAP,
  R_SUM, R_CC0, R_CC1, R_CC2, R_CC3, R_CC4, R_CC5, R_CC6, R_CC7, R_AFF0,
  R_AFF1,
  R_TAB0, R_TAB1, R_TAB2, R_TAB3, R_SEL, R_JOIN, R_CMP0, R_FSQR, R_FMUL,
  R_CMP1, R_WTAB, R_WMUL, R__ = 0xff,
};

LH_DEV lh_op lh_routine_op(int r, int pc) {
  switch (r) {
    case R_SSWU: return LH_R_SSWU[pc];
    case R_PSQR: return LH_R_PSQR[pc];
    case R_SQRT: return LH_R_SQRT[pc];
    case R_ISO: return LH_R_ISO[pc];
    case R_DBLA: return LH_R_DBLA[pc];
    case R_DBLB: return LH_R_DBLB[pc];
    case R_ADD: return LH_R_ADD[pc];
    case R_SWAP: return LH_R_SWAP[pc];
    case R_SUM: return LH_R_SUM[pc];
    case R_CC0: return LH_R_CC0[pc];
    case R_CC1: return LH_R_CC1[pc];
    case R_CC2: return LH_R_CC2[pc];
    case R_CC3: return LH_R_CC3[pc];
    case R_CC4: return LH_R_CC4[pc];
    case R_CC5: return LH_R_CC5[pc];
    case R_CC6: return LH_R_CC6[pc];
    case R_CC7: return LH_R_CC7[pc];
    case R_AFF0: return LH_R_AFF0[pc];
    case R_AFF1: return LH_R_AFF1[pc];
    case R_TAB0: return LH_R_TAB0[pc];
    case R_TAB1: return LH_R_TAB1[pc];
    case R_TAB2: return LH_R_TAB2[pc];
    case R_TAB3: return LH_R_TAB3[pc];
    case R_SEL: return LH_R_SEL[pc];
    case R_JOIN: return LH_R_JOIN[pc];
    case R_CMP0: return LH_R_CMP0[pc];
    case R_FSQR: return LH_R_FSQR[pc];
    case R_FMUL: return LH_R_FMUL[pc];
    case R_CMP1: return LH_R_CMP1[pc];
    case R_WTAB: return LH_R_WTAB[pc];
    case R_WMUL: return LH_R_WMUL[pc];
    default: {
      lh_op end = {V_END, 0, 0, 0};
      return end;
    }
  }
}

// ------------------------------------------------------------ scripts ---

// Q_RUN: routines r0, r1, r2 (R__ skips).  Q_POW: over the bits of
// exponent r2 below its top bit, MSB first, r0 every bit and r1 where the
// bit is set.  Q_LADDER: r0, r1, r2 for each step j = 63..0.  Q_WPOW:
// the table routine r2, then c3's sliding windows (LH_C3_WIN): r0 for
// each squaring, r1 (by the window's odd power) for each window.
enum { Q_RUN, Q_POW, Q_LADDER, Q_WPOW, Q_END };
enum { E_ABSX, E_PM2 };                    // |x|, p - 2
struct lh_sc { uint8_t k, r0, r1, r2; };

// The hash of the pair's (u0, u1) to H = PA (Jacobian) on both threads.
#define LH_C3_POW {Q_WPOW, R_PSQR, R_WMUL, R_WTAB}
#define LH_HASH_SCRIPT                                                    \
    {Q_RUN, R_SSWU, R__, R__}, LH_C3_POW,                                  \
    {Q_RUN, R_SQRT, R_ISO, R_SWAP}, {Q_RUN, R_DBLB, R_ADD, R_SUM},        \
    {Q_RUN, R_DBLB, R__, R__}, {Q_POW, R_DBLA, R_ADD, E_ABSX},            \
    {Q_RUN, R_CC0, R_DBLB, R_CC1}, {Q_POW, R_DBLA, R_ADD, E_ABSX},        \
    {Q_RUN, R_CC2, R_DBLB, R_ADD}, {Q_RUN, R_CC3, R_DBLB, R_ADD},         \
    {Q_RUN, R_CC4, R_DBLB, R_ADD}, {Q_RUN, R_CC5, R_DBLB, R_ADD},         \
    {Q_RUN, R_CC6, R_DBLA, R_CC7}, {Q_RUN, R_DBLB, R_ADD, R__}
// [k] H and its compression: the table, the ladder, the join.
#define LH_SIGN_SCRIPT                                                    \
    {Q_RUN, R_TAB0, R_DBLB, R_ADD}, {Q_RUN, R_TAB1, R_DBLA, R_TAB2},      \
    {Q_RUN, R_DBLA, R_TAB3, R__}, {Q_LADDER, R_DBLA, R_SEL, R_ADD},       \
    {Q_RUN, R_JOIN, R_DBLB, R_ADD}, {Q_RUN, R_CMP0, R__, R__},            \
    {Q_POW, R_FSQR, R_FMUL, E_PM2}, {Q_RUN, R_CMP1, R__, R__}
#define LH_SCRIPT_END {Q_END, 0, 0, 0}

LH_CONST lh_sc LH_S_HASH[] = {LH_HASH_SCRIPT, {Q_RUN, R_AFF0, R__, R__},
                              LH_SCRIPT_END};
LH_CONST lh_sc LH_S_AFF[] = {{Q_RUN, R_AFF1, R__, R__}, LH_SCRIPT_END};

LH_CONST lh_sc LH_S_SIGN[] = {LH_HASH_SCRIPT, LH_SIGN_SCRIPT, LH_SCRIPT_END};
// For a host harness: one map (u at MU -> QP), the signing half from H =
// PA loaded by the caller, and one complete addition PA = PA + PB.
LH_CONST lh_sc LH_S_MAP[] = {
    {Q_RUN, R_SSWU, R__, R__}, LH_C3_POW,
    {Q_RUN, R_SQRT, R_ISO, R__}, LH_SCRIPT_END};
LH_CONST lh_sc LH_S_LADDER[] = {LH_SIGN_SCRIPT, LH_SCRIPT_END};
LH_CONST lh_sc LH_S_ADD[] = {{Q_RUN, R_DBLB, R_ADD, R__}, LH_SCRIPT_END};
enum { S_HASH, S_AFF, S_SIGN, S_MAP, S_LADDER, S_ADD };

LH_DEV lh_sc lh_script(int s, int i) {
  switch (s) {
    case S_HASH: return LH_S_HASH[i];
    case S_AFF: return LH_S_AFF[i];
    case S_SIGN: return LH_S_SIGN[i];
    case S_MAP: return LH_S_MAP[i];
    case S_LADDER: return LH_S_LADDER[i];
    default: return LH_S_ADD[i];
  }
}

// Bit i of exponent e, and its top set bit.
LH_DEV int lh_exp_bit(int e, int i) {
  if (e == E_ABSX) return (int)((LH_ABS_X >> i) & 1);
  return (int)((LH_EXP_INV.v[i >> 5] >> (i & 31)) & 1);
}
LH_DEV int lh_exp_top(int e) {
  int top = e == E_ABSX ? 63 : 32 * LH_NL - 1;
  while (top > 0 && !lh_exp_bit(e, top)) top--;
  return top;
}

// ------------------------------------------------------------ digits ----

// k mod r for k < 2^255 (bit 255 of the words is dropped: the plain ladder
// runs 255 bits): one subtraction of r kept under a mask (k < 2r).
LH_DEV void lh_mod_r(uint32_t k[8]) {
  lh_cf f{0};
  uint32_t d[8];
  k[7] &= 0x7fffffffu;
  d[0] = sub_cc(f, k[0], LH_R_WORDS[0]);
#pragma unroll
  for (int i = 1; i < 8; i++) d[i] = subc_cc(f, k[i], LH_R_WORDS[i]);
  const uint32_t keep = subc(f, 0u, 0u);   // all ones where k < r
#pragma unroll
  for (int i = 0; i < 8; i++) k[i] = (k[i] & keep) | (d[i] & ~keep);
}

// n <- n / |x|, returns n mod |x|: restoring division, 256 fixed steps of
// a shift and a masked subtraction (never the card's variable-time 64-bit
// division).
LH_DEV uint64_t lh_div_absx(uint32_t n[8]) {
  const uint64_t z = LH_ABS_X;
  uint64_t rem = 0;
  for (int s = 0; s < 256; s++) {
    const uint32_t top = n[7] >> 31;
#pragma unroll
    for (int i = 7; i > 0; i--) n[i] = (n[i] << 1) | (n[i - 1] >> 31);
    n[0] <<= 1;
    const uint64_t hi = rem >> 63;
    rem = (rem << 1) | top;
    const uint64_t ge = hi | (uint64_t)(rem >= z);
    rem -= z & (0ull - ge);
    n[0] |= (uint32_t)ge;                   // the quotient shifts in
  }
  return rem;
}

// The base-|x| digits d0..d3 of k mod r as (lo, hi) words, in dg[8].
LH_DEV void lh_digits(uint32_t dg[8], const uint32_t* w) {
  uint32_t k[8];
#pragma unroll
  for (int i = 0; i < 8; i++) k[i] = w[i];
  lh_mod_r(k);
#pragma unroll
  for (int i = 0; i < 3; i++) {
    const uint64_t d = lh_div_absx(k);
    dg[2 * i] = (uint32_t)d;
    dg[2 * i + 1] = (uint32_t)(d >> 32);
  }
  dg[6] = k[0];                             // d3 < |x|: two words
  dg[7] = k[1];
}

// ------------------------------------------------------------ machine ---

struct lh_vm {
  uint32_t* sm;       // the block's slots
  int nt, t;          // threads in the block (the pair's 2 on the host)
  uint32_t fl;        // flags
  uint32_t da0, da1, db0, db1;   // this thread's digit pair (lo, hi)
  int script, si, stage, rt, pc, bit, wix;

  LH_MEM void init(uint32_t* s, int nthreads, int tid, int sc) {
    sm = s;
    nt = nthreads;
    t = tid;
    fl = (uint32_t)(tid & 1) << F_ODD;
    da0 = da1 = db0 = db1 = 0;
    start(sc);
  }
  LH_MEM void start(int sc) {
    script = sc;
    si = stage = pc = bit = wix = 0;
    rt = -1;
  }

  LH_MEM uint32_t* word(int k, int w) { return sm + (k * 24 + w) * nt + t; }
  LH_MEM void ld(fp2_t& r, int k) {
    uint32_t* d = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
    for (int w = 0; w < 24; w++) d[w] = *word(k, w);
  }
  LH_MEM void st(int k, const fp2_t& a) {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(&a);
#pragma unroll
    for (int w = 0; w < 24; w++) *word(k, w) = s[w];
  }
  LH_MEM void ld_thread(fp2_t& r, int k, int tt) {
    uint32_t* d = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
    for (int w = 0; w < 24; w++) d[w] = sm[(k * 24 + w) * nt + tt];
  }

  LH_MEM void konst(fp2_t& r, int k) {
    if (k >= K_ISO) {
      r = LH_ISO[(k - K_ISO) >> 2][(k - K_ISO) & 3];
      return;
    }
    switch (k) {
      case K_ONE: set_one(r); break;
      case K_RAW1: set_zero(r); r.c0.v[0] = 1; break;
      case K_A: r = LH_SSWU_A; break;
      case K_B: r = LH_SSWU_B; break;
      case K_Z: r = LH_SSWU_Z; break;
      case K_C6: r = LH_SSWU_C6; break;
      case K_C7: r = LH_SSWU_C7; break;
      case K_PSIX: r = LH_PSI_CX; break;
      case K_PSIY: r = LH_PSI_CY; break;
      default: set_zero(r); break;
    }
  }

  LH_MEM uint32_t flag(int f) {
    return ((fl >> (f & 0x1f)) & 1u) ^ (uint32_t)((f >> 7) & 1);
  }
  LH_MEM void set_flag(int f, uint32_t v) {
    fl = (fl & ~(1u << f)) | ((v & 1u) << f);
  }

  // Point d = entry e (0: infinity) of the table at a, by masks.
  LH_MEM void tsel(int d, int a, int dbl) {
    const uint32_t sa = bit < 32 ? (da0 >> bit) : (da1 >> (bit - 32));
    const uint32_t sb = bit < 32 ? (db0 >> bit) : (db1 >> (bit - 32));
    const uint32_t sel = (sa & 1u) | ((sb & 1u) << 1);
    const uint32_t m1 = mask_of(sel == 1), m2 = mask_of(sel == 2),
                   m3 = mask_of(sel == 3), m0 = mask_of(sel == 0);
    const int base = a + 9 * dbl;
    for (int c = 0; c < 3; c++) {
      fp2_t e1, e2, e3, r;
      ld(e1, base + c);
      ld(e2, base + 3 + c);
      ld(e3, base + 6 + c);
      const uint32_t* x1 = reinterpret_cast<const uint32_t*>(&e1);
      const uint32_t* x2 = reinterpret_cast<const uint32_t*>(&e2);
      const uint32_t* x3 = reinterpret_cast<const uint32_t*>(&e3);
      uint32_t* o = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
      for (int w = 0; w < 24; w++)
        o[w] = (x1[w] & m1) | (x2[w] & m2) | (x3[w] & m3);
      if (c == 1) {                          // infinity is (0, 1, 0)
#pragma unroll
        for (int w = 0; w < LH_NL; w++) o[w] |= LH_ONE.v[w] & m0;
      }
      st(d + c, r);
    }
  }

  // One operation (the execution site).
  LH_MEM void exec(const lh_op o) {
    fp2_t x, y, r;
    switch (o.k) {
      case V_MUL: case V_MULK: case V_SQR: case V_ADD: case V_ADDK:
      case V_SUB: case V_NEG: case V_CONJ: case V_COPY: case V_CMOV:
      case V_EQK: case V_ISZ: case V_SGN: case V_FSQR: case V_FMUL:
      case V_MULW:
        ld(x, o.a);
        break;
      default:
        break;
    }
    switch (o.k) {
      case V_MUL: case V_ADD: case V_SUB: case V_FMUL:
        ld(y, o.b);
        break;
      case V_MULW:
        ld(y, WT + wix);
        break;
      case V_MULK: case V_ADDK: case V_EQK:
        konst(y, o.b);
        break;
      case V_LDK: case V_CMOVK:
        konst(x, o.a);
        break;
      default:
        break;
    }
    switch (o.k) {
      case V_MUL: case V_MULK: case V_MULW: {
        fp_t t0, t1, t2, sa, sb;
        add(sa, x.c0, x.c1);
        add(sb, y.c0, y.c1);
        fmul(t0, x.c0, y.c0);
        fmul(t1, x.c1, y.c1);
        fmul(t2, sa, sb);
        sub(r.c0, t0, t1);
        sub(t2, t2, t0);
        sub(r.c1, t2, t1);
        st(o.d, r);
        break;
      }
      case V_SQR: {
        fp_t s, d, m;
        add(s, x.c0, x.c1);
        sub(d, x.c0, x.c1);
        fmul(m, x.c0, x.c1);
        fmul(r.c0, s, d);
        add(r.c1, m, m);
        st(o.d, r);
        break;
      }
      case V_FMUL:
        set_zero(r.c1);
        fmul(r.c0, x.c0, y.c0);
        st(o.d, r);
        break;
      case V_ADD: case V_ADDK:
        add(r, x, y);
        st(o.d, r);
        break;
      case V_SUB:
        sub(r, x, y);
        st(o.d, r);
        break;
      case V_NEG:
        neg(r, x);
        st(o.d, r);
        break;
      case V_CONJ:
        conj(r, x);
        st(o.d, r);
        break;
      case V_COPY: case V_LDK:
        st(o.d, x);
        break;
      case V_CMOV: case V_CMOVK:
        ld(y, o.d);
        ct_select(r, x, y, mask_of(flag(o.b) != 0));
        st(o.d, r);
        break;
      case V_EQK: {
        uint32_t acc = 0;
        const uint32_t* a = reinterpret_cast<const uint32_t*>(&x);
        const uint32_t* b = reinterpret_cast<const uint32_t*>(&y);
#pragma unroll
        for (int w = 0; w < 24; w++) acc |= a[w] ^ b[w];
        set_flag(o.d, acc == 0);
        break;
      }
      case V_ISZ:
        set_flag(o.d, is_zero(x));
        break;
      case V_FAND:
        set_flag(o.d, flag(o.a) & flag(o.b));
        break;
      case V_SGN: {
        const uint32_t z0 = is_zero(x.c0);
        const uint32_t s = (x.c0.v[0] & 1u) | (z0 & x.c1.v[0] & 1u);
        set_flag(o.d, s ^ flag(o.b));
        break;
      }
      case V_FSQR:
        set_zero(r.c1);
        fsqr(r.c0, x.c0);
        st(o.d, r);
        break;
      case V_PAIR:
        ld_thread(r, o.a, (t & ~1) | o.b);
        st(o.d, r);
        break;
      case V_TSEL:
        tsel(o.d, o.a, o.b);
        break;
      default:
        break;
    }
  }

  // The next operation of the script (V_SYNC and V_END included).
  LH_MEM lh_op next() {
    for (;;) {
      if (rt >= 0) {
        const lh_op o = lh_routine_op(rt, pc++);
        if (o.k != V_RET) return o;
        rt = -1;
      }
      const lh_sc s = lh_script(script, si);
      switch (s.k) {
        case Q_RUN: {
          if (stage == 3) {
            stage = 0;
            si++;
            break;
          }
          const int r = stage == 0 ? s.r0 : (stage == 1 ? s.r1 : s.r2);
          stage++;
          if (r != R__) {
            rt = r;
            pc = 0;
          }
          break;
        }
        case Q_POW:
          // stage: 0 start, 1 the square, 2 the multiply, 3 next bit
          if (stage == 0) {
            bit = lh_exp_top(s.r2);
            stage = 3;
          }
          if (stage == 3) {
            if (--bit < 0) {
              stage = 0;
              si++;
              break;
            }
            stage = 1;
          }
          if (stage == 1) {
            rt = s.r0;
            pc = 0;
            stage = 2;
          } else {
            if (lh_exp_bit(s.r2, bit)) {
              rt = s.r1;
              pc = 0;
            }
            stage = 3;
          }
          break;
        case Q_LADDER:
          // stage: 0 start, 1..3 r0..r2, 4 next step
          if (stage == 0) {
            bit = 64;
            stage = 4;
          }
          if (stage == 4) {
            if (--bit < 0) {
              stage = 0;
              si++;
              break;
            }
            stage = 1;
          }
          rt = stage == 1 ? s.r0 : (stage == 2 ? s.r1 : s.r2);
          pc = 0;
          stage = stage == 3 ? 4 : stage + 1;
          break;
        case Q_WPOW:
          // stage 0 the table; then bit = the window, wix its index and
          // stage 1 + the squarings done so far
          if (stage == 0) {
            rt = s.r2;
            pc = 0;
            bit = 0;
            stage = 1;
            break;
          }
          if (bit == LH_C3_NWIN) {
            stage = 0;
            si++;
            break;
          }
          if (stage - 1 < LH_C3_WIN[2 * bit]) {
            rt = s.r0;
            pc = 0;
            stage++;
          } else {
            wix = LH_C3_WIN[2 * bit + 1];
            if (wix != 255) {
              rt = s.r1;
              pc = 0;
            }
            bit++;
            stage = 1;
          }
          break;
        default: {
          lh_op end = {V_END, 0, 0, 0};
          return end;
        }
      }
    }
  }

  // Runs to the next swap point (true) or the end of the script (false).
  LH_MEM bool run() {
    for (;;) {
      const lh_op o = next();
      if (o.k == V_SYNC) return true;
      if (o.k == V_END) return false;
      exec(o);
    }
  }

  // Slot MU = u (canonical plain limbs, 24 words) in Montgomery form, and
  // flag F_U = sgn0(u).
  LH_MEM void load_u(const uint32_t* u) {
    fp2_t up, m;
    load(up, u);
    to_mont(m.c0, up.c0);
    to_mont(m.c1, up.c1);
    st(MU, m);
    const uint32_t z0 = is_zero(up.c0);
    set_flag(F_U, (up.c0.v[0] & 1u) | (z0 & up.c1.v[0] & 1u));
  }

  // The digit pair of this thread: (d0, d1) even, (d2, d3) odd.
  LH_MEM void load_scalar(const uint32_t* w) {
    uint32_t dg[8];
    lh_digits(dg, w);
    const bool odd = t & 1;
    da0 = odd ? dg[4] : dg[0];
    da1 = odd ? dg[5] : dg[1];
    db0 = odd ? dg[6] : dg[2];
    db1 = odd ? dg[7] : dg[3];
  }
};

// k_hash between LH_S_HASH and LH_S_AFF: T0 = (1 / N, 0) for the norm N in
// T0's c0, by the binary extended Euclid (variable time: the hash's data
// is public); 1/0 = 0, so infinity gives (0, 0).
LH_MEM void lh_invert_norm(lh_vm& vm) {
  fp2_t n;
  vm.ld(n, T0);
  fp_t r;
  fp_inv_vt(r, n.c0);
  n.c0 = r;
  vm.st(T0, n);
}

#ifdef __CUDACC__
// Dynamic shared memory of a block of nt threads with ns slots each.
static inline size_t lh_vm_smem(int ns, int nt) {
  return (size_t)ns * 24 * sizeof(uint32_t) * nt;
}
#endif
