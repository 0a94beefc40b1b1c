// k_points: the random-weight ladders of batch verification and the sum of
// the weighted signatures:
//   w_i = [r_i] P_i  (G1, affine out),   S = sum_i [r_i] sig_i  (G2, affine)
// with 64-bit weights r_i given as two little-endian uint32 words.
//
// Replaces lighthouse_tpu/crypto/bls/tpu/staged.py:89 k_points and, with the
// pubkey mask, staged.py:156 k_points_multi (XLA programs over
// curve.scalar_mul_dynamic, curve.sum_reduce, verify.aggregate_points_g1).
// Three launches:
//   1. (mask variant) one block per set sums its k <= 512 masked pubkeys:
//      each thread adds a strided share, then a shared-memory tree;
//   2. one thread per lane runs the G1 and G2 ladders (MSB-first double and
//      add, complete additions) and converts [r_i] P_i to affine;
//   3. one block sums the n weighted signatures: strided shares, then a
//      shared-memory tree, then the affine conversion.
// Padding lanes (weight 0, infinity) contribute infinity.  Bound: 32-bit
// multiply-adds (~64 doublings + ~32 additions on each group per lane, plus
// one Fermat inversion per lane); the bytes moved are a few KB.
//
// In:  xp, yp (n, 12), pinf (n,) -- or xpk, ypk (n, k, 12), ipk, mask
//      (n, k); xs, ys (n, 2, 12), sinf (n,); rand (n, 2).
// Out: wx, wy (n, 12), winf (n,); sx, sy (2, 12), ssinf (1,).
// Mask variant: a set with no key or an infinity signature is inactive: its
// signature counts as infinity and winf is set (as k_points_multi does).
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include "bls12_381.cuh"

#define AGG_THREADS 128
#define SUM_THREADS 64

// Strided share of one set's masked pubkey sum (launch 1, thread t of nt).
LH_NI void agg_partial(g1_t& acc, bool& any, const uint32_t* xpk,
                       const uint32_t* ypk, const uint8_t* ipk,
                       const uint8_t* mask, int k, int t, int nt) {
  pt_set_inf(acc);
  any = false;
  for (int j = t; j < k; j += nt) {
    if (!mask[j]) continue;
    any = true;
    if (ipk[j]) continue;
    g1_t p;
    fp_t x, y;
    load(x, xpk + 12 * (size_t)j);
    load(y, ypk + 12 * (size_t)j);
    pt_from_affine(p, x, y, false);
    pt_add(acc, acc, p);
  }
}

// One lane of launch 2.  pk_jac (36 words) replaces the affine pubkey in
// the mask variant, where act says whether the set is active.
LH_NI void ladder_lane(const uint32_t* xp, const uint32_t* yp, bool pinf,
                       const uint32_t* pk_jac, bool has_act, bool act,
                       const uint32_t* xs, const uint32_t* ys, bool sinf,
                       const uint32_t* rand, uint32_t* wx, uint32_t* wy,
                       uint8_t* winf, uint32_t* ws_jac) {
  g1_t pk, wp;
  if (pk_jac) {
    load_words(pk, pk_jac);
  } else {
    fp_t x, y;
    load(x, xp);
    load(y, yp);
    pt_from_affine(pk, x, y, pinf);
  }
  bool active = has_act ? (act && !sinf) : true;
  g2_t sig, ws;
  fp2_t x2, y2;
  load(x2, xs);
  load(y2, ys);
  pt_from_affine(sig, x2, y2, sinf || !active);
  uint64_t r = (uint64_t)rand[0] | ((uint64_t)rand[1] << 32);
  pt_mul_u64(wp, pk, r);
  pt_mul_u64(ws, sig, r);
  fp_t ax, ay;
  bool inf = pt_to_affine(ax, ay, wp);
  store(wx, ax);
  store(wy, ay);
  *winf = (inf || !active) ? 1 : 0;
  store_words(ws_jac, ws);
}

// Strided share of the weighted-signature sum (launch 3).
LH_NI void sum_partial(g2_t& acc, const uint32_t* ws_jac, int n, int t,
                       int nt) {
  pt_set_inf(acc);
  for (int i = t; i < n; i += nt) {
    g2_t p;
    load_words(p, ws_jac + 72 * (size_t)i);
    pt_add(acc, acc, p);
  }
}

#ifdef __CUDACC__
__global__ void k_points_agg_kernel(const uint32_t* __restrict__ xpk,
                                    const uint32_t* __restrict__ ypk,
                                    const uint8_t* __restrict__ ipk,
                                    const uint8_t* __restrict__ mask, int k,
                                    uint32_t* __restrict__ pk_jac,
                                    uint8_t* __restrict__ act) {
  __shared__ g1_t sh[AGG_THREADS];
  int s = blockIdx.x, t = threadIdx.x;
  size_t off = (size_t)s * k;
  g1_t acc;
  bool any;
  agg_partial(acc, any, xpk + 12 * off, ypk + 12 * off, ipk + off,
              mask + off, k, t, AGG_THREADS);
  sh[t] = acc;
  int any_block = __syncthreads_or(any ? 1 : 0);
  for (int w = AGG_THREADS / 2; w > 0; w >>= 1) {
    if (t < w) {
      g1_t a = sh[t], b = sh[t + w];
      pt_add(a, a, b);
      sh[t] = a;
    }
    __syncthreads();
  }
  if (t == 0) {
    store_words(pk_jac + 36 * (size_t)s, sh[0]);
    act[s] = any_block ? 1 : 0;
  }
}

__global__ void k_points_ladder_kernel(
    const uint32_t* __restrict__ xp, const uint32_t* __restrict__ yp,
    const uint8_t* __restrict__ pinf, const uint32_t* __restrict__ pk_jac,
    const uint8_t* __restrict__ act, const uint32_t* __restrict__ xs,
    const uint32_t* __restrict__ ys, const uint8_t* __restrict__ sinf,
    const uint32_t* __restrict__ rand, uint32_t* __restrict__ wx,
    uint32_t* __restrict__ wy, uint8_t* __restrict__ winf,
    uint32_t* __restrict__ ws_jac, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  ladder_lane(pk_jac ? nullptr : xp + 12 * (size_t)i,
              pk_jac ? nullptr : yp + 12 * (size_t)i,
              pk_jac ? false : (bool)pinf[i],
              pk_jac ? pk_jac + 36 * (size_t)i : nullptr,
              act != nullptr, act ? (bool)act[i] : true,
              xs + 24 * (size_t)i, ys + 24 * (size_t)i, (bool)sinf[i],
              rand + 2 * (size_t)i, wx + 12 * (size_t)i, wy + 12 * (size_t)i,
              winf + i, ws_jac + 72 * (size_t)i);
}

__global__ void k_points_sum_kernel(const uint32_t* __restrict__ ws_jac,
                                    int n, uint32_t* __restrict__ sx,
                                    uint32_t* __restrict__ sy,
                                    uint8_t* __restrict__ ssinf) {
  __shared__ g2_t sh[SUM_THREADS];
  int t = threadIdx.x;
  g2_t acc;
  sum_partial(acc, ws_jac, n, t, SUM_THREADS);
  sh[t] = acc;
  __syncthreads();
  for (int w = SUM_THREADS / 2; w > 0; w >>= 1) {
    if (t < w) {
      g2_t a = sh[t], b = sh[t + w];
      pt_add(a, a, b);
      sh[t] = a;
    }
    __syncthreads();
  }
  if (t == 0) {
    fp2_t x, y;
    g2_t total = sh[0];
    bool inf = pt_to_affine(x, y, total);
    store(sx, x);
    store(sy, y);
    ssinf[0] = inf ? 1 : 0;
  }
}

// xpk == NULL selects the single-key variant (xp, yp, pinf); otherwise the
// mask variant (xpk, ypk, ipk, mask with k keys a set).  Scratch: pk_jac
// (n, 36) and act (n,) for the mask variant, ws_jac (n, 72) always.
extern "C" int k_points_launch(
    const void* xp, const void* yp, const void* pinf, const void* xpk,
    const void* ypk, const void* ipk, const void* mask, int n, int k,
    const void* xs, const void* ys, const void* sinf, const void* rand,
    void* wx, void* wy, void* winf, void* sx, void* sy, void* ssinf,
    void* pk_jac, void* act, void* ws_jac, void* stream) {
  if (n <= 0) return 0;
  cudaError_t e = lh_ensure_stack(LH_STACK_BYTES);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  bool multi = xpk != nullptr;
  if (multi) {
    k_points_agg_kernel<<<n, AGG_THREADS, 0, st>>>(
        (const uint32_t*)xpk, (const uint32_t*)ypk, (const uint8_t*)ipk,
        (const uint8_t*)mask, k, (uint32_t*)pk_jac, (uint8_t*)act);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  int threads = 32;
  int blocks = (n + threads - 1) / threads;
  k_points_ladder_kernel<<<blocks, threads, 0, st>>>(
      (const uint32_t*)xp, (const uint32_t*)yp, (const uint8_t*)pinf,
      multi ? (const uint32_t*)pk_jac : nullptr,
      multi ? (const uint8_t*)act : nullptr, (const uint32_t*)xs,
      (const uint32_t*)ys, (const uint8_t*)sinf, (const uint32_t*)rand,
      (uint32_t*)wx, (uint32_t*)wy, (uint8_t*)winf, (uint32_t*)ws_jac, n);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  k_points_sum_kernel<<<1, SUM_THREADS, 0, st>>>(
      (const uint32_t*)ws_jac, n, (uint32_t*)sx, (uint32_t*)sy,
      (uint8_t*)ssinf);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
