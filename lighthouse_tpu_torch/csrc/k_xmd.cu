// k_xmd: SHA-256 expand_message_xmd of 32-byte signing roots, reduced to
// the hash-to-field elements (u0, u1) of RFC 9380 hash_to_field.
//
// Replaces lighthouse_tpu/crypto/bls/tpu/staged.py:58 k_xmd (an XLA program
// over hash_to_g2.hash_to_field_device).  One thread per message: 19
// SHA-256 compressions (3 for b0, 2 for each of b1..b8), then each 64-byte
// chunk goes mod p with two Montgomery products (hi 2^384 + lo ->
// hi R^2 + lo R, then out of Montgomery form).  Bound: integer ALU work of
// the compressions, ~19 x 64 rounds per message; the bytes moved (32 in,
// 192 out) are negligible.
//
// In:  msg (n, 8) uint32 big-endian words.  Out: u (n, 2, 2, 12) uint32,
// canonical plain (not Montgomery) limbs of (u0.c0, u0.c1, u1.c0, u1.c1).
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include "xmd.cuh"

#ifdef __CUDACC__
__global__ void k_xmd_kernel(const uint32_t* __restrict__ msg,
                             uint32_t* __restrict__ out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) xmd_lane(msg + 8 * (size_t)i, out + 48 * (size_t)i);
}

extern "C" int k_xmd_launch(const void* msg, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  int threads = 64;
  int blocks = (n + threads - 1) / threads;
  k_xmd_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)msg, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
