// k_points: the random-weight ladders of batch verification and the sum of
// the weighted signatures:
//   w_i = [r_i] P_i  (G1, affine out),   S = sum_i [r_i] sig_i  (G2, affine)
// with 64-bit weights r_i given as two little-endian uint32 words.
//
// Replaces lighthouse_tpu/crypto/bls/tpu/staged.py:89 k_points and, with the
// pubkey mask, staged.py:156 k_points_multi (XLA programs over
// curve.scalar_mul_dynamic, curve.sum_reduce, verify.aggregate_points_g1).
// Three launches on the block-cooperative point code of points_coop.cuh:
//   1. (mask variant) k_points_agg_kernel: one block a set sums its
//      k <= 512 masked pubkeys over AGG_ACC accumulators, then a tree;
//      the Jacobian sum and the set's act flag go to scratch;
//   2. k_points_ladder_kernel: one block a lane runs the G1 and G2 ladders
//      side by side (MSB first from the weight's top bit, complete
//      additions), then [r_i] P_i's affine words by one binary-Euclid
//      inverse; [r_i] sig_i goes to scratch in Jacobian words;
//   3. k_points_sum_kernel: one block sums the n weighted signatures over
//      SUM_ACC accumulators and a tree, then the affine sum (the norm's
//      inverse).
// A lane with weight 0, or with both points at infinity, runs no round but
// its load and store.  Bound: the latency of chains of Fp products (~63
// doublings of 3 product rounds and ~32 additions of 4 a lane, the sum's
// additions), not bytes (a few KB) or the multiply-add rate.  No launch
// needs a per-thread stack.
//
// In:  xp, yp (n, 12), pinf (n,) -- or xpk, ypk (n, k, 12), ipk, mask
//      (n, k); xs, ys (n, 2, 12), sinf (n,); rand (n, 2).
// Out: wx, wy (n, 12), winf (n,); sx, sy (2, 12), ssinf (1,).
// Mask variant: a set with no key or an infinity signature is inactive: its
// signature counts as infinity and winf is set (as k_points_multi does).
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include "points_coop.cuh"

// The blocks' layouts; other layouts build with -D for a comparison
// (lighthouse_tpu_torch/tools/points_layouts.py).  LAD_PROD_THREADS ==
// LAD_THREADS runs a round's products and then its sums on every thread.
#ifndef LAD_THREADS
#define LAD_THREADS 96         // 64 take products (20 a round), 32 sums
#endif
#ifndef LAD_PROD_THREADS
#define LAD_PROD_THREADS (LAD_THREADS - 32)
#endif
#ifndef SUM_THREADS
#define SUM_THREADS 384        // all take products (120 a round), then sums
#endif
#ifndef SUM_ACC
#define SUM_ACC 64             // accumulators of the signature sum
#endif
#ifndef AGG_THREADS
#define AGG_THREADS 384
#endif
#ifndef AGG_ACC
#define AGG_ACC 64             // accumulators of a set's key sum
#endif

#ifdef __CUDACC__
extern __shared__ __align__(16) unsigned char pc_smem[];

__global__ void __launch_bounds__(AGG_THREADS, 1) k_points_agg_kernel(
    const uint32_t* __restrict__ xpk, const uint32_t* __restrict__ ypk,
    const uint8_t* __restrict__ ipk, const uint8_t* __restrict__ mask, int k,
    uint32_t* __restrict__ pk_jac, uint8_t* __restrict__ act) {
  auto& s = *reinterpret_cast<pc_state<AGG_ACC>*>(pc_smem);
  const size_t set = blockIdx.x, off = set * (size_t)k;
  lh_block<AGG_THREADS, AGG_THREADS, lh_ptx> g{(int)threadIdx.x};
  pc_reduce<AGG_ACC> pr{{s, 0, 0, false}, true, xpk + 12 * off,
                        ypk + 12 * off, ipk + off, mask + off, k,
                        pk_jac + 36 * set, nullptr, act + set};
  lh_run(g, pr);
}

__global__ void __launch_bounds__(LAD_THREADS) k_points_ladder_kernel(
    const uint32_t* __restrict__ xp, const uint32_t* __restrict__ yp,
    const uint8_t* __restrict__ pinf, const uint32_t* __restrict__ pk_jac,
    const uint8_t* __restrict__ act, const uint32_t* __restrict__ xs,
    const uint32_t* __restrict__ ys, const uint8_t* __restrict__ sinf,
    const uint32_t* __restrict__ rand, uint32_t* __restrict__ wx,
    uint32_t* __restrict__ wy, uint8_t* __restrict__ winf,
    uint32_t* __restrict__ ws_jac) {
  __shared__ pc_state<2> s;
  const size_t i = blockIdx.x;
  lh_block<LAD_PROD_THREADS, LAD_THREADS, lh_ptx> g{(int)threadIdx.x};
  const bool multi = pk_jac != nullptr;
  const bool si = sinf[i] != 0;
  pc_ladder pr{{s, 0, 0, false},
               multi ? nullptr : xp + 12 * i, multi ? nullptr : yp + 12 * i,
               multi ? false : pinf[i] != 0,
               multi ? pk_jac + 36 * i : nullptr,
               multi ? (act[i] != 0 && !si) : true,
               xs + 24 * i, ys + 24 * i, si,
               (uint64_t)rand[2 * i] | ((uint64_t)rand[2 * i + 1] << 32),
               wx + 12 * i, wy + 12 * i, winf + i, ws_jac + 72 * i, 0};
  lh_run(g, pr);
}

__global__ void __launch_bounds__(SUM_THREADS, 1) k_points_sum_kernel(
    const uint32_t* __restrict__ ws_jac, int n, uint32_t* __restrict__ sx,
    uint32_t* __restrict__ sy, uint8_t* __restrict__ ssinf) {
  auto& s = *reinterpret_cast<pc_state<SUM_ACC>*>(pc_smem);
  lh_block<SUM_THREADS, SUM_THREADS, lh_ptx> g{(int)threadIdx.x};
  pc_reduce<SUM_ACC> pr{{s, 0, 0, false}, false, ws_jac, nullptr, nullptr,
                        nullptr, n, sx, sy, ssinf};
  lh_run(g, pr);
}

template <class K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Launch 3 alone: the sum of n Jacobian G2 points at ws_jac (n, 72), affine
// out (k_points_launch's last launch; the layout tool times it apart).
extern "C" int k_points_sum_launch(const void* ws_jac, int n, void* sx,
                                   void* sy, void* ssinf, void* stream) {
  const size_t smem = sizeof(pc_state<SUM_ACC>);
  cudaError_t e = allow_smem(k_points_sum_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  k_points_sum_kernel<<<1, SUM_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)ws_jac, n, (uint32_t*)sx, (uint32_t*)sy,
      (uint8_t*)ssinf);
  return (int)cudaGetLastError();
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
  cudaStream_t st = (cudaStream_t)stream;
  const bool multi = xpk != nullptr;
  cudaError_t e;
  if (multi) {
    const size_t smem = sizeof(pc_state<AGG_ACC>);
    e = allow_smem(k_points_agg_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    k_points_agg_kernel<<<n, AGG_THREADS, smem, st>>>(
        (const uint32_t*)xpk, (const uint32_t*)ypk, (const uint8_t*)ipk,
        (const uint8_t*)mask, k, (uint32_t*)pk_jac, (uint8_t*)act);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  k_points_ladder_kernel<<<n, LAD_THREADS, 0, st>>>(
      (const uint32_t*)xp, (const uint32_t*)yp, (const uint8_t*)pinf,
      multi ? (const uint32_t*)pk_jac : nullptr,
      multi ? (const uint8_t*)act : nullptr, (const uint32_t*)xs,
      (const uint32_t*)ys, (const uint8_t*)sinf, (const uint32_t*)rand,
      (uint32_t*)wx, (uint32_t*)wy, (uint8_t*)winf, (uint32_t*)ws_jac);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return k_points_sum_launch(ws_jac, n, sx, sy, ssinf, stream);
}

// Blocks of each kernel an SM holds at once (the runtime's occupancy for
// these layouts, registers and shared memory): out[0] the ladder kernel,
// out[1] the sum kernel, out[2] the key-sum kernel; out is a host pointer.
extern "C" int k_points_occupancy(int* out) {
  cudaError_t e = allow_smem(k_points_sum_kernel, sizeof(pc_state<SUM_ACC>));
  if (e == cudaSuccess)
    e = allow_smem(k_points_agg_kernel, sizeof(pc_state<AGG_ACC>));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], k_points_ladder_kernel, LAD_THREADS, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[1], k_points_sum_kernel, SUM_THREADS, sizeof(pc_state<SUM_ACC>));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], k_points_agg_kernel, AGG_THREADS, sizeof(pc_state<AGG_ACC>));
  return (int)e;
}

// The accumulator counts this build has (a caller that crafts inputs for
// the sums' exceptional cases checks them): out[0] SUM_ACC, out[1] AGG_ACC.
extern "C" void k_points_accumulators(int* out) {
  out[0] = SUM_ACC;
  out[1] = AGG_ACC;
}
#endif  // __CUDACC__
