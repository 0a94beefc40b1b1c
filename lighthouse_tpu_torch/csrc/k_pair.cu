// k_pair: the batch-verification multi-pairing
//   prod_i e(w_i, H(m_i)) * e(-g1, S) == 1
// over n weighted pubkeys w_i with their message points H(m_i), plus the
// pair (-g1, S) of the weighted signature sum.
//
// Replaces lighthouse_tpu/crypto/bls/tpu/staged.py:104 k_pair (an XLA
// program over pairing.multi_pairing_is_one).  Two launches:
//   1. one thread per pair lane (n + 1 lanes) runs the Miller loop of
//      miller.cuh over the 63 bits of |x| = 0xd201000000010000 below the
//      leading one; a lane with an infinity point gives f = 1.  f_i goes to
//      scratch (n + 1, 144 words).
//   2. one block multiplies the lane values (strided shares, then a
//      shared-memory tree), and its first thread runs the final
//      exponentiation and the is-one test.
// The final exponentiation is one thread's work (~14,000 Fp products) and
// is this kernel's latency floor.  Bound: 32-bit multiply-adds (~10,000 Fp
// products per lane in the loop); bytes are a few KB.
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
//     sum), then one block multiplies the lane values (the strided shares
//     and shared-memory tree of launch 2) and writes the product, one Fp12
//     (144 words), with no final exponentiation;
//   k_pair_combine: launch 2 over the S shard partials (m = S): their
//     product, the final exponentiation and the is-one test.
// Their bounds are launch 1's and launch 2's: the shard's Miller loops, and
// the one-thread final exponentiation (~14,000 Fp products).
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include "miller.cuh"

#define FIN_THREADS 64

// Strided share of the lane product (launch 2).
LH_NI void product_partial(fp12_t& acc, const uint32_t* f_all, int m, int t,
                           int nt) {
  set_one(acc);
  for (int i = t; i < m; i += nt) {
    fp12_t x;
    load_words(x, f_all + 144 * (size_t)i);
    mul(acc, acc, x);
  }
}

#ifdef __CUDACC__
__global__ void k_pair_miller_kernel(
    const uint32_t* __restrict__ wx, const uint32_t* __restrict__ wy,
    const uint8_t* __restrict__ winf, const uint32_t* __restrict__ hx,
    const uint32_t* __restrict__ hy, const uint8_t* __restrict__ hinf,
    const uint32_t* __restrict__ sx, const uint32_t* __restrict__ sy,
    const uint8_t* __restrict__ ssinf, uint32_t* __restrict__ f_all, int n,
    int closing) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i > n || (i == n && !closing)) return;
  fp_t xp, yp;
  fp2_t xq, yq;
  bool inactive;
  if (i < n) {
    load(xp, wx + 12 * (size_t)i);
    load(yp, wy + 12 * (size_t)i);
    load(xq, hx + 24 * (size_t)i);
    load(yq, hy + 24 * (size_t)i);
    inactive = winf[i] || hinf[i];
  } else {                           // (-g1, S)
    xp = LH_G1_X;
    yp = LH_G1_NEG_Y;
    load(xq, sx);
    load(yq, sy);
    inactive = ssinf[0];
  }
  fp12_t f;
  miller_lane(f, xp, yp, xq, yq, inactive);
  store_words(f_all + 144 * (size_t)i, f);
}

__global__ void k_pair_final_kernel(const uint32_t* __restrict__ f_all, int m,
                                    uint8_t* __restrict__ ok,
                                    uint32_t* __restrict__ gt) {
  __shared__ fp12_t sh[FIN_THREADS];
  int t = threadIdx.x;
  fp12_t acc;
  product_partial(acc, f_all, m, t, FIN_THREADS);
  sh[t] = acc;
  __syncthreads();
  for (int w = FIN_THREADS / 2; w > 0; w >>= 1) {
    if (t < w) {
      fp12_t a = sh[t], b = sh[t + w];
      mul(a, a, b);
      sh[t] = a;
    }
    __syncthreads();
  }
  if (t == 0) {
    fp12_t prod = sh[0], r;
    final_exponentiation(r, prod);
    store_words(gt, r);
    ok[0] = is_one(r) ? 1 : 0;
  }
}

// The product of m lane values in one block, no final exponentiation.
__global__ void k_pair_reduce_kernel(const uint32_t* __restrict__ f_all,
                                     int m, uint32_t* __restrict__ out) {
  __shared__ fp12_t sh[FIN_THREADS];
  int t = threadIdx.x;
  fp12_t acc;
  product_partial(acc, f_all, m, t, FIN_THREADS);
  sh[t] = acc;
  __syncthreads();
  for (int w = FIN_THREADS / 2; w > 0; w >>= 1) {
    if (t < w) {
      fp12_t a = sh[t], b = sh[t + w];
      mul(a, a, b);
      sh[t] = a;
    }
    __syncthreads();
  }
  if (t == 0) store_words(out, sh[0]);
}

extern "C" int k_pair_launch(const void* wx, const void* wy, const void* winf,
                             const void* hx, const void* hy, const void* hinf,
                             const void* sx, const void* sy, const void* ssinf,
                             int n, void* f_all, void* ok, void* gt,
                             void* stream) {
  if (n < 0) return 0;
  cudaError_t e = lh_ensure_stack(LH_STACK_BYTES);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  int m = n + 1;
  int threads = 32;
  int blocks = (m + threads - 1) / threads;
  k_pair_miller_kernel<<<blocks, threads, 0, st>>>(
      (const uint32_t*)wx, (const uint32_t*)wy, (const uint8_t*)winf,
      (const uint32_t*)hx, (const uint32_t*)hy, (const uint8_t*)hinf,
      (const uint32_t*)sx, (const uint32_t*)sy, (const uint8_t*)ssinf,
      (uint32_t*)f_all, n, 1);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  k_pair_final_kernel<<<1, FIN_THREADS, 0, st>>>(
      (const uint32_t*)f_all, m, (uint8_t*)ok, (uint32_t*)gt);
  return (int)cudaGetLastError();
}

extern "C" int k_pair_partial_launch(const void* wx, const void* wy,
                                     const void* winf, const void* hx,
                                     const void* hy, const void* hinf,
                                     const void* sx, const void* sy,
                                     const void* ssinf, int n, int closing,
                                     void* f_all, void* out, void* stream) {
  if (n < 0) return 0;
  cudaError_t e = lh_ensure_stack(LH_STACK_BYTES);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  int m = n + (closing ? 1 : 0);
  int threads = 32;
  int blocks = (m + threads - 1) / threads;
  if (blocks > 0) {
    k_pair_miller_kernel<<<blocks, threads, 0, st>>>(
        (const uint32_t*)wx, (const uint32_t*)wy, (const uint8_t*)winf,
        (const uint32_t*)hx, (const uint32_t*)hy, (const uint8_t*)hinf,
        (const uint32_t*)sx, (const uint32_t*)sy, (const uint8_t*)ssinf,
        (uint32_t*)f_all, n, closing);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  k_pair_reduce_kernel<<<1, FIN_THREADS, 0, st>>>((const uint32_t*)f_all, m,
                                                 (uint32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int k_pair_combine_launch(const void* parts, int s, void* ok,
                                     void* gt, void* stream) {
  if (s < 0) return 0;
  cudaError_t e = lh_ensure_stack(LH_STACK_BYTES);
  if (e != cudaSuccess) return (int)e;
  k_pair_final_kernel<<<1, FIN_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)parts, s, (uint8_t*)ok, (uint32_t*)gt);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
