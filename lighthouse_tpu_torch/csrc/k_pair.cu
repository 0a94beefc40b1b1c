// k_pair: the batch-verification multi-pairing
//   prod_i e(w_i, H(m_i)) * e(-g1, S) == 1
// over n weighted pubkeys w_i with their message points H(m_i), plus the
// pair (-g1, S) of the weighted signature sum.
//
// Replaces lighthouse_tpu/crypto/bls/tpu/staged.py:104 k_pair (an XLA
// program over pairing.multi_pairing_is_one).  Two launches, both on the
// block-cooperative code of pair_coop.cuh:
//   1. k_pair_miller_kernel: one block of 128 threads a pair lane (n + 1
//      lanes): the lane's Miller loop over the 63 bits of |x| =
//      0xd201000000010000 below the leading one, its state in shared
//      memory, each round's Fp2 products on three lanes each; a lane with
//      an infinity point gives f = 1.  f_i goes to scratch (n + 1, 144
//      words).
//   2. k_pair_final_kernel<true>: one block of 448 threads multiplies the
//      lane values (three accumulators, then a tree) and runs the final
//      exponentiation and the is-one test, each Fp12 operation spread over
//      the block.
// Bound: the latency of the chains of Fp products (~215 product rounds a
// Miller lane, ~330 in the final exponentiation), not bytes (a few KB) or
// the multiply-add rate; the lanes fill up to 132 SMs at once.
//
// In:  wx, wy (n, 12), winf (n,); hx, hy (n, 2, 12), hinf (n,);
//      sx, sy (2, 12), ssinf (1,).
// Out: ok (1,) uint8 verdict; gt (2, 3, 2, 12) the GT value of the product.
//
// The mesh step (lighthouse_tpu/parallel/sharded_verify.py:269
// _cross_chip_pair, :119-127; parallel/ring.py:122-124) splits this kernel
// at its product:
//   k_pair_partial: launch 1 over one shard's n lanes, plus the closing lane
//     (-g1, S) only when `closing` (shard 0; S is the cross-shard signature
//     sum), then k_pair_final_kernel<false>: the product of the lane values,
//     one Fp12 (144 words), with no final exponentiation;
//   k_pair_combine: launch 2 over the S shard partials (m = S): their
//     product, the final exponentiation and the is-one test.
// None of these launches needs a per-thread stack (ptxas: 0-byte frames).
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include "pair_coop.cuh"

// The blocks' layouts; other layouts build with -D for a comparison
// (lighthouse_tpu_torch/tools/pair_layouts.py).  Product threads come in
// warps; MILLER_PROD_THREADS == MILLER_THREADS runs a round's products and
// then its sums on every thread.
#ifndef MILLER_THREADS
#define MILLER_THREADS 128     // 96 take products (30 a round), 32 sums
#endif
#ifndef MILLER_PROD_THREADS
#define MILLER_PROD_THREADS (MILLER_THREADS - 32)
#endif
#ifndef FIN_THREADS
#define FIN_THREADS 448        // all take products (140 a round), then sums
#endif

#ifdef __CUDACC__
__global__ void __launch_bounds__(MILLER_THREADS, 1) k_pair_miller_kernel(
    const uint32_t* __restrict__ wx, const uint32_t* __restrict__ wy,
    const uint8_t* __restrict__ winf, const uint32_t* __restrict__ hx,
    const uint32_t* __restrict__ hy, const uint8_t* __restrict__ hinf,
    const uint32_t* __restrict__ sx, const uint32_t* __restrict__ sy,
    const uint8_t* __restrict__ ssinf, uint32_t* __restrict__ f_all, int n) {
  __shared__ mill_t s;
  int i = blockIdx.x;                  // grid: the lanes, closing last
  lh_block<MILLER_PROD_THREADS, MILLER_THREADS> g{(int)threadIdx.x};
  bool lane = i < n;
  mill_prog pr{s, lane ? wx + 12 * (size_t)i : nullptr,
               lane ? wy + 12 * (size_t)i : nullptr,
               lane ? hx + 24 * (size_t)i : sx, lane ? hy + 24 * (size_t)i : sy,
               lane ? (winf[i] || hinf[i]) : ssinf[0] != 0,
               f_all + 144 * (size_t)i, 0};
  lh_run(g, pr);                       // no wx, wy: (-g1, S)
}

template <bool FE>
__global__ void __launch_bounds__(FIN_THREADS, 1) k_pair_final_kernel(
    const uint32_t* __restrict__ f_all, int m, uint8_t* __restrict__ ok,
    uint32_t* __restrict__ out) {
  __shared__ fin_t s;
  lh_block<FIN_THREADS, FIN_THREADS> g{(int)threadIdx.x};
  fin_prog pr{s, f_all, m, FE, out, ok, fin_k0(m)};
  lh_run(g, pr);
}

static cudaError_t launch_miller(const void* wx, const void* wy,
                                 const void* winf, const void* hx,
                                 const void* hy, const void* hinf,
                                 const void* sx, const void* sy,
                                 const void* ssinf, int n, int lanes,
                                 void* f_all, cudaStream_t st) {
  if (lanes <= 0) return cudaSuccess;
  k_pair_miller_kernel<<<lanes, MILLER_THREADS, 0, st>>>(
      (const uint32_t*)wx, (const uint32_t*)wy, (const uint8_t*)winf,
      (const uint32_t*)hx, (const uint32_t*)hy, (const uint8_t*)hinf,
      (const uint32_t*)sx, (const uint32_t*)sy, (const uint8_t*)ssinf,
      (uint32_t*)f_all, n);
  return cudaGetLastError();
}

extern "C" int k_pair_launch(const void* wx, const void* wy, const void* winf,
                             const void* hx, const void* hy, const void* hinf,
                             const void* sx, const void* sy, const void* ssinf,
                             int n, void* f_all, void* ok, void* gt,
                             void* stream) {
  if (n < 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = launch_miller(wx, wy, winf, hx, hy, hinf, sx, sy, ssinf, n,
                                n + 1, f_all, st);
  if (e != cudaSuccess) return (int)e;
  k_pair_final_kernel<true><<<1, FIN_THREADS, 0, st>>>(
      (const uint32_t*)f_all, n + 1, (uint8_t*)ok, (uint32_t*)gt);
  return (int)cudaGetLastError();
}

extern "C" int k_pair_partial_launch(const void* wx, const void* wy,
                                     const void* winf, const void* hx,
                                     const void* hy, const void* hinf,
                                     const void* sx, const void* sy,
                                     const void* ssinf, int n, int closing,
                                     void* f_all, void* out, void* stream) {
  if (n < 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  int m = n + (closing ? 1 : 0);
  cudaError_t e = launch_miller(wx, wy, winf, hx, hy, hinf, sx, sy, ssinf, n,
                                m, f_all, st);
  if (e != cudaSuccess) return (int)e;
  k_pair_final_kernel<false><<<1, FIN_THREADS, 0, st>>>(
      (const uint32_t*)f_all, m, nullptr, (uint32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int k_pair_combine_launch(const void* parts, int s, void* ok,
                                     void* gt, void* stream) {
  if (s < 0) return 0;
  k_pair_final_kernel<true><<<1, FIN_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)parts, s, (uint8_t*)ok, (uint32_t*)gt);
  return (int)cudaGetLastError();
}
// Blocks of each kernel an SM holds at once (the runtime's occupancy for
// these layouts, registers and shared memory): out[0] the Miller kernel,
// out[1] the final kernel; out is a host pointer.
extern "C" int k_pair_occupancy(int* out) {
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], k_pair_miller_kernel, MILLER_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], k_pair_final_kernel<true>, FIN_THREADS, 0);
}
#endif  // __CUDACC__
