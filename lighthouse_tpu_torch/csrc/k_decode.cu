// k_decode: on-card deserialization of wire G2 signatures, and k_and, the
// verdict combiner.
//
// k_decode replaces lighthouse_tpu/crypto/bls/tpu/staged.py:66 k_decode (an
// XLA program over curve.g2_decompress, curve.g2_subgroup_check and
// curve.to_affine).  The host parses the 96 wire bytes into flags and the
// canonical limbs of x (cuda/backend.py parse_g2_compressed_many); one
// thread per lane then runs
//   y = sqrt(x^3 + 4(1 + u)) (the norm-based Fp2 square root), the sign
//   choice on the real value of y, the subgroup check psi(P) == -[|z|] P
//   (a 64-bit ladder and a projective compare), and writes the affine
//   Montgomery point (Z is 1 or 0, so no inversion is needed).
// The all-lanes verdict ok is set to 1 on the stream (cudaMemsetAsync)
// before the lane kernel runs; a lane that is off the curve, outside the
// subgroup, or a malformed infinity writes 0 (every writer writes the same
// value, so the race is benign).
// Bound: 32-bit multiply-adds (three 381-bit exponentiations of the square
// root and a 64-bit G2 ladder a lane, ~2,000 Fp products); the bytes are
// ~250 a lane.
//
// k_and replaces staged.py:81 k_and: one thread ANDs two device verdicts,
// so the wire path reads back one byte.
//
// In:  x (m, 2, 12) canonical plain limbs; sign, inf (m,) uint8.
// Out: xs, ys (m, 2, 12) affine Montgomery; si (m,) uint8; ok (1,) uint8.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include "bls12_381.cuh"

// One lane: returns whether it is valid (on the curve and in the subgroup,
// or a well-formed infinity).
LH_NI bool decode_lane(const uint32_t* x, bool sign, bool inf, uint32_t* xs,
                       uint32_t* ys, uint8_t* si) {
  fp2_t xw, ax, ay;
  load(xw, x);
  g2_t pt;
  bool ok = g2_decompress(pt, xw, sign, inf);
  ok = ok && (inf || g2_subgroup_check(pt));
  bool pinf = pt_is_inf(pt);
  if (pinf) {
    set_zero(ax);
    set_zero(ay);
  } else {
    ax = pt.x;
    ay = pt.y;
  }
  store(xs, ax);
  store(ys, ay);
  *si = (pinf || inf) ? 1 : 0;
  return ok;
}

#ifdef __CUDACC__
__global__ void k_decode_kernel(const uint32_t* __restrict__ x,
                                const uint8_t* __restrict__ sign,
                                const uint8_t* __restrict__ inf,
                                uint32_t* __restrict__ xs,
                                uint32_t* __restrict__ ys,
                                uint8_t* __restrict__ si,
                                uint8_t* __restrict__ ok, int m) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  bool good = decode_lane(x + 24 * (size_t)i, sign[i] != 0, inf[i] != 0,
                          xs + 24 * (size_t)i, ys + 24 * (size_t)i, si + i);
  if (!good) ok[0] = 0;
}

__global__ void k_and_kernel(const uint8_t* __restrict__ a,
                             const uint8_t* __restrict__ b,
                             uint8_t* __restrict__ out) {
  out[0] = (a[0] && b[0]) ? 1 : 0;
}

extern "C" int k_decode_launch(const void* x, const void* sign,
                               const void* inf, int m, void* xs, void* ys,
                               void* si, void* ok, void* stream) {
  cudaError_t e = lh_ensure_stack(LH_STACK_BYTES);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  e = cudaMemsetAsync(ok, 1, 1, st);        // the AND over no lane is true
  if (e != cudaSuccess || m <= 0) return (int)e;
  int threads = 32;
  int blocks = (m + threads - 1) / threads;
  k_decode_kernel<<<blocks, threads, 0, st>>>(
      (const uint32_t*)x, (const uint8_t*)sign, (const uint8_t*)inf,
      (uint32_t*)xs, (uint32_t*)ys, (uint8_t*)si, (uint8_t*)ok, m);
  return (int)cudaGetLastError();
}

extern "C" int k_and_launch(const void* a, const void* b, void* out,
                            void* stream) {
  k_and_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)a, (const uint8_t*)b, (uint8_t*)out);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
