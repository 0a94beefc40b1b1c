// k_ring: the cross-shard folds of the mesh step.
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
// k_ring_mul is pair_coop.cuh's fin_prog over m = 2 values without the
// final exponentiation, a and b each from its own pointer, on one block of
// RING_MUL_THREADS: a load round, one round of the 36 Fp2 products a_i b_j
// (three lanes of a warp each, fp_ptx.cuh's fmul), one round of their
// sums into the six w-coefficients, a store round.  Bound: the latency of
// that one round of products and the launch, not bytes (864) or the
// multiply-add rate.
// k_ring_sum is points_coop.cuh's pc_reduce on one block with affine
// points as its source: RING_ACC accumulators take the first points (the
// rest stream in by complete additions), a halving tree of complete
// additions sums them (P == Q by a masked doubling, P == -Q and infinity
// as the engine's cases), then the affine tail: the norm Z conj(Z), one
// binary-Euclid inverse in one thread, conj(Z) / N, X / Z^2, Y / Z^3.
// Bound: the latency of chains of Fp products (S = 2: one addition of 4
// product rounds and 1 sum round, the tail's 4 product rounds and the
// inverse), not bytes (~200) or the multiply-add rate.  No launch needs a
// per-thread stack.
//
// k_ring_mul in:  a, b (2, 3, 2, 12) Montgomery words.  out: the same shape.
// k_ring_sum in:  x, y (S, 2, 12) affine Montgomery, inf (S,) uint8.
//            out: ox, oy (2, 12), oinf (1,) uint8.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include "points_coop.cuh"

// k_ring_mul's block: RING_MUL_THREADS threads, all taking a round's
// products (the 36 of the product round in one pass, ten a warp), then its
// sums.  k_ring_sum's: RING_ACC accumulators (S = 2 is one tree level, 4
// two), RING_THREADS threads, all taking a round's products, then its sums
// (a level of two additions is 12 product tasks: ten a warp).
constexpr int RING_MUL_THREADS = 128;
constexpr int RING_ACC = 4;
constexpr int RING_THREADS = 64;

#ifdef __CUDACC__
__global__ void __launch_bounds__(RING_MUL_THREADS, 1) k_ring_mul_kernel(
    const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
    uint32_t* __restrict__ out) {
  __shared__ fin_t s;
  lh_block<RING_MUL_THREADS, RING_MUL_THREADS, lh_ptx> g{(int)threadIdx.x};
  fin_prog pr{s, a, 2, false, out, nullptr, fin_k0(2)};
  pr.f_b = b;
  lh_run(g, pr);
}

__global__ void __launch_bounds__(RING_THREADS, 1) k_ring_sum_kernel(
    const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
    const uint8_t* __restrict__ inf, int s, uint32_t* __restrict__ ox,
    uint32_t* __restrict__ oy, uint8_t* __restrict__ oinf) {
  __shared__ pc_state<RING_ACC> st;
  lh_block<RING_THREADS, RING_THREADS, lh_ptx> g{(int)threadIdx.x};
  pc_reduce<RING_ACC> pr{{st, 0, 0, false}, false, x, y, inf, nullptr, s,
                         ox, oy, oinf};
  lh_run(g, pr);
}

extern "C" int k_ring_mul_launch(const void* a, const void* b, void* out,
                                 void* stream) {
  k_ring_mul_kernel<<<1, RING_MUL_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int k_ring_sum_launch(const void* x, const void* y,
                                 const void* inf, int s, void* ox, void* oy,
                                 void* oinf, void* stream) {
  if (s < 0) return 0;
  k_ring_sum_kernel<<<1, RING_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const uint8_t*)inf, s,
      (uint32_t*)ox, (uint32_t*)oy, (uint8_t*)oinf);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
