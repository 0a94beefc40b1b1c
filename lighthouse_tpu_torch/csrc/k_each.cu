// k_each: n per-set verdicts in one call,
//   ok_i = e(P_i, H_i) * e(-g1, sig_i) == 1  and  P_i, sig_i not infinity,
// the individual verification of TSignature::verify and of the per-set
// fallback after a failed batch.
//
// Replaces lighthouse_tpu/crypto/bls/tpu/backend.py:90 _verify_each_kernel
// (an XLA program over verify.verify_each, tpu/verify.py:47) after its
// hash-to-G2: H_i comes in affine from k_xmd / k_hash.  Two launches:
//   1. one thread per pair lane (2n lanes: (P_i, H_i) and (-g1, sig_i)) runs
//      the Miller loop of miller.cuh; f goes to scratch (2n, 144 words);
//   2. one thread per set multiplies its two lane values and runs the final
//      exponentiation and the is-one test, masked by the infinity flags.
// Every set pays a full final exponentiation (~14,000 Fp products, one
// thread each), which with the Miller loops bounds this kernel: 32-bit
// multiply-adds.  The final exponentiation's __noinline__ chain needs the
// 16 KB per-thread stack of lh_ensure_stack, for n threads at once.
//
// In:  xp, yp (n, 12), pinf (n,); xs, ys (n, 2, 12), sinf (n,);
//      hx, hy (n, 2, 12), hinf (n,).
// Out: ok (n,) uint8.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include "miller.cuh"

#ifdef __CUDACC__
__global__ void k_each_miller_kernel(
    const uint32_t* __restrict__ xp, const uint32_t* __restrict__ yp,
    const uint8_t* __restrict__ pinf, const uint32_t* __restrict__ xs,
    const uint32_t* __restrict__ ys, const uint8_t* __restrict__ sinf,
    const uint32_t* __restrict__ hx, const uint32_t* __restrict__ hy,
    const uint8_t* __restrict__ hinf, uint32_t* __restrict__ f_all, int n) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= 2 * n) return;
  int i = j >> 1;
  fp_t px, py;
  fp2_t qx, qy;
  bool inactive;
  if ((j & 1) == 0) {                // (P_i, H_i)
    load(px, xp + 12 * (size_t)i);
    load(py, yp + 12 * (size_t)i);
    load(qx, hx + 24 * (size_t)i);
    load(qy, hy + 24 * (size_t)i);
    inactive = pinf[i] || hinf[i];
  } else {                           // (-g1, sig_i)
    px = LH_G1_X;
    py = LH_G1_NEG_Y;
    load(qx, xs + 24 * (size_t)i);
    load(qy, ys + 24 * (size_t)i);
    inactive = sinf[i] != 0;
  }
  fp12_t f;
  miller_lane(f, px, py, qx, qy, inactive);
  store_words(f_all + 144 * (size_t)j, f);
}

__global__ void k_each_final_kernel(const uint32_t* __restrict__ f_all,
                                    const uint8_t* __restrict__ pinf,
                                    const uint8_t* __restrict__ sinf,
                                    uint8_t* __restrict__ ok, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fp12_t a, b, r;
  load_words(a, f_all + 144 * (size_t)(2 * i));
  load_words(b, f_all + 144 * (size_t)(2 * i + 1));
  mul(a, a, b);
  final_exponentiation(r, a);
  ok[i] = (is_one(r) && !pinf[i] && !sinf[i]) ? 1 : 0;
}

extern "C" int k_each_launch(const void* xp, const void* yp, const void* pinf,
                             const void* xs, const void* ys, const void* sinf,
                             const void* hx, const void* hy, const void* hinf,
                             int n, void* f_all, void* ok, void* stream) {
  if (n <= 0) return 0;
  cudaError_t e = lh_ensure_stack(LH_STACK_BYTES);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  int threads = 32;
  k_each_miller_kernel<<<(2 * n + threads - 1) / threads, threads, 0, st>>>(
      (const uint32_t*)xp, (const uint32_t*)yp, (const uint8_t*)pinf,
      (const uint32_t*)xs, (const uint32_t*)ys, (const uint8_t*)sinf,
      (const uint32_t*)hx, (const uint32_t*)hy, (const uint8_t*)hinf,
      (uint32_t*)f_all, n);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  k_each_final_kernel<<<(n + threads - 1) / threads, threads, 0, st>>>(
      (const uint32_t*)f_all, (const uint8_t*)pinf, (const uint8_t*)sinf,
      (uint8_t*)ok, n);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
