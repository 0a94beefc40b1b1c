// k_hash: hash-to-G2 of the field elements (u0, u1) -- SSWU map on the
// 3-isogenous curve, the isogeny, the sum of both points, cofactor clearing
// and the affine conversion: H(m) as the pairing stage reads it.
//
// Replaces lighthouse_tpu/crypto/bls/tpu/staged.py:51 k_hash (an XLA program
// over hash_to_g2.hash_to_g2_device + curve.to_affine).  One thread per
// message runs hash_to_g2 of hash_g2.cuh and the affine conversion.
// Bound: 32-bit multiply-adds of ~8,000 Fp products a lane; the bytes moved
// (192 in, 196 out) are negligible.
//
// In:  u (n, 2, 2, 12) plain canonical limbs.
// Out: hx, hy (n, 2, 12) Montgomery canonical, hinf (n,) uint8.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include "hash_g2.cuh"

// One message: u (48 words) -> hx, hy (24 words each), hinf.
LH_NI void hash_lane(const uint32_t* u, uint32_t* hx, uint32_t* hy,
                     uint8_t* hinf) {
  g2_t q;
  hash_to_g2(q, u);
  fp2_t x, y;
  bool inf = pt_to_affine(x, y, q);
  store(hx, x);
  store(hy, y);
  *hinf = inf ? 1 : 0;
}

#ifdef __CUDACC__
__global__ void k_hash_kernel(const uint32_t* __restrict__ u,
                              uint32_t* __restrict__ hx,
                              uint32_t* __restrict__ hy,
                              uint8_t* __restrict__ hinf, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    hash_lane(u + 48 * (size_t)i, hx + 24 * (size_t)i, hy + 24 * (size_t)i,
              hinf + i);
}

extern "C" int k_hash_launch(const void* u, void* hx, void* hy, void* hinf,
                             int n, void* stream) {
  if (n <= 0) return 0;
  cudaError_t e = lh_ensure_stack(LH_STACK_BYTES);
  if (e != cudaSuccess) return (int)e;
  int threads = 32;
  int blocks = (n + threads - 1) / threads;
  k_hash_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)u, (uint32_t*)hx, (uint32_t*)hy, (uint8_t*)hinf, n);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
