// k_ring: the cross-shard folds of the mesh step, one thread each.
//   k_ring_mul: out = a * b in Fp12, one hop of the Fp12 ring (replaces the
//     fold of lighthouse_tpu/parallel/ring.py:37 ring_reduce_fp12: the
//     tower.mul after each ppermute);
//   k_ring_sum: the affine sum, with its infinity flag, of S affine G2
//     points with infinity flags, by complete additions (two shards may hold
//     equal sums, or both infinity).  With S = 2 (the accumulator and the
//     arriving point) it is one hop of the G2 ring (ring.py:61 ring_sum_g2,
//     curve.add after each ppermute); with S = the shard count it is the
//     gathered sum of the all-gather form and its affine conversion
//     (parallel/sharded_verify.py:97 curve.sum_reduce of _gather_point, and
//     the to_affine of :278-283).
// The values are a few hundred bytes; the work is one Fp12 product (54 Fp
// products) or S - 1 G2 additions and one Fp2 inversion (~500 Fp products),
// so a launch is latency, not throughput: one thread on one SM.
//
// k_ring_mul in:  a, b (2, 3, 2, 12) Montgomery words.  out: the same shape.
// k_ring_sum in:  x, y (S, 2, 12) affine Montgomery, inf (S,) uint8.
//            out: ox, oy (2, 12), oinf (1,) uint8.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include "bls12_381.cuh"

// The affine sum of s affine points (x = y = 0 where infinity).
LH_NI void ring_sum_g2(fp2_t& ox, fp2_t& oy, bool& oinf, const uint32_t* x,
                       const uint32_t* y, const uint8_t* inf, int s) {
  g2_t acc;
  pt_set_inf(acc);
  for (int i = 0; i < s; i++) {
    fp2_t px, py;
    load(px, x + 24 * (size_t)i);
    load(py, y + 24 * (size_t)i);
    g2_t p;
    pt_from_affine(p, px, py, inf[i] != 0);
    pt_add(acc, acc, p);
  }
  oinf = pt_to_affine(ox, oy, acc);
}

#ifdef __CUDACC__
__global__ void k_ring_mul_kernel(const uint32_t* __restrict__ a,
                                  const uint32_t* __restrict__ b,
                                  uint32_t* __restrict__ out) {
  fp12_t fa, fb, r;
  load_words(fa, a);
  load_words(fb, b);
  mul(r, fa, fb);
  store_words(out, r);
}

__global__ void k_ring_sum_kernel(const uint32_t* __restrict__ x,
                                  const uint32_t* __restrict__ y,
                                  const uint8_t* __restrict__ inf, int s,
                                  uint32_t* __restrict__ ox,
                                  uint32_t* __restrict__ oy,
                                  uint8_t* __restrict__ oinf) {
  fp2_t rx, ry;
  bool ri;
  ring_sum_g2(rx, ry, ri, x, y, inf, s);
  store(ox, rx);
  store(oy, ry);
  oinf[0] = ri ? 1 : 0;
}

extern "C" int k_ring_mul_launch(const void* a, const void* b, void* out,
                                 void* stream) {
  cudaError_t e = lh_ensure_stack(LH_STACK_BYTES);
  if (e != cudaSuccess) return (int)e;
  k_ring_mul_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int k_ring_sum_launch(const void* x, const void* y,
                                 const void* inf, int s, void* ox, void* oy,
                                 void* oinf, void* stream) {
  if (s < 0) return 0;
  cudaError_t e = lh_ensure_stack(LH_STACK_BYTES);
  if (e != cudaSuccess) return (int)e;
  k_ring_sum_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const uint8_t*)inf, s,
      (uint32_t*)ox, (uint32_t*)oy, (uint8_t*)oinf);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
