// k_each: n per-set verdicts in one call,
//   ok_i = e(P_i, H_i) * e(-g1, sig_i) == 1  and  P_i, sig_i not infinity,
// the individual verification of TSignature::verify and of the per-set
// fallback after a failed batch.
//
// Replaces lighthouse_tpu/crypto/bls/tpu/backend.py:90 _verify_each_kernel
// (an XLA program over verify.verify_each, tpu/verify.py:47) after its
// hash-to-G2: H_i comes in affine from k_xmd / k_hash.  Two launches, both
// on the block-cooperative pairing of pair_coop.cuh (as k_pair.cu):
//   1. k_each_miller_kernel: one block a pair lane over 2n lanes, lane 2i
//      (P_i, H_i), off when P_i or H_i is infinity, lane 2i + 1 (-g1,
//      sig_i), off when sig_i is infinity; f goes to scratch (2n, 144
//      words);
//   2. k_each_final_kernel: one block a set (224 threads, two an SM)
//      multiplies its two lane values and runs the final exponentiation
//      and the is-one test (fin_prog with m = 2), its GT value over its
//      first lane's scratch row; the verdict is ANDed with "P_i and sig_i
//      finite", and a set with either at infinity is False without a
//      round.
// Bound: the latency of chains of Fp products (~215 product rounds a Miller
// lane, ~330 a final exponentiation), one wave of blocks up to ~130 sets
// (Miller: 3 blocks an SM); the bytes moved are a few KB.  No launch needs
// a per-thread stack.
//
// In:  xp, yp (n, 12), pinf (n,); xs, ys (n, 2, 12), sinf (n,);
//      hx, hy (n, 2, 12), hinf (n,).
// Out: ok (n,) uint8.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include "pair_coop.cuh"

// The blocks' layouts; other layouts build with -D for a comparison
// (lighthouse_tpu_torch/tools/points_layouts.py).  The Miller block is
// k_pair.cu's; the final block has half of k_pair's threads, so two fit an
// SM: as fast at 64 sets, a fifth faster at 1,024.  The product site runs
// fp_ptx.cuh's fmul (k_pair.cu keeps the CIOS mul): an eighth faster at 64
// sets, a fifth at 1,024 (PERF.md, the k_each layouts).
#ifndef EACH_FIN_THREADS
#define EACH_FIN_THREADS 224      // all take products, then sums
#endif

#ifdef __CUDACC__
__global__ void __launch_bounds__(128, 1) k_each_miller_kernel(
    const uint32_t* __restrict__ xp, const uint32_t* __restrict__ yp,
    const uint8_t* __restrict__ pinf, const uint32_t* __restrict__ xs,
    const uint32_t* __restrict__ ys, const uint8_t* __restrict__ sinf,
    const uint32_t* __restrict__ hx, const uint32_t* __restrict__ hy,
    const uint8_t* __restrict__ hinf, uint32_t* __restrict__ f_all) {
  __shared__ mill_t s;
  const int j = blockIdx.x, i = j >> 1;
  const bool sig = j & 1;              // (-g1, sig_i): no P words
  lh_block<96, 128, lh_ptx> g{(int)threadIdx.x};   // 96 products, 32 sums
  mill_prog pr{s, sig ? nullptr : xp + 12 * (size_t)i,
               sig ? nullptr : yp + 12 * (size_t)i,
               (sig ? xs : hx) + 24 * (size_t)i,
               (sig ? ys : hy) + 24 * (size_t)i,
               sig ? sinf[i] != 0 : (pinf[i] || hinf[i]),
               f_all + 144 * (size_t)j, 0};
  lh_run(g, pr);
}

__global__ void __launch_bounds__(EACH_FIN_THREADS, 1) k_each_final_kernel(
    uint32_t* __restrict__ f_all, const uint8_t* __restrict__ pinf,
    const uint8_t* __restrict__ sinf, uint8_t* __restrict__ ok) {
  __shared__ fin_t s;
  const int i = blockIdx.x;
  if (pinf[i] || sinf[i]) {            // uniform over the block
    if (threadIdx.x == 0) ok[i] = 0;
    return;
  }
  uint32_t* f = f_all + 288 * (size_t)i;
  lh_block<EACH_FIN_THREADS, EACH_FIN_THREADS, lh_ptx> g{(int)threadIdx.x};
  fin_prog pr{s, f, 2, true, f, ok + i, fin_k0(2)};
  lh_run(g, pr);                       // reads f in its first round only
}

extern "C" int k_each_launch(const void* xp, const void* yp, const void* pinf,
                             const void* xs, const void* ys, const void* sinf,
                             const void* hx, const void* hy, const void* hinf,
                             int n, void* f_all, void* ok, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  k_each_miller_kernel<<<2 * n, 128, 0, st>>>(
      (const uint32_t*)xp, (const uint32_t*)yp, (const uint8_t*)pinf,
      (const uint32_t*)xs, (const uint32_t*)ys, (const uint8_t*)sinf,
      (const uint32_t*)hx, (const uint32_t*)hy, (const uint8_t*)hinf,
      (uint32_t*)f_all);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  k_each_final_kernel<<<n, EACH_FIN_THREADS, 0, st>>>(
      (uint32_t*)f_all, (const uint8_t*)pinf, (const uint8_t*)sinf,
      (uint8_t*)ok);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
