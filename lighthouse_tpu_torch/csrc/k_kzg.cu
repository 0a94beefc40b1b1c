// k_blob_eval: barycentric evaluation of B blobs at their challenges,
//   p(z) = (z^N - 1) / N * sum_i p_i w^i / (z - w^i),
// with the exact domain-point guard p(w^i) = p_i.
//
// Replaces lighthouse_tpu/crypto/kzg/kernels.py:76 k_blob_eval (an XLA
// program over crypto/kzg/fr.py, with one batched product-tree inversion
// of all B x N denominators).  Here one block evaluates one blob:
//   * each of the KZG_THREADS threads takes a contiguous chunk of the N
//     elements (N / KZG_THREADS of them, or one when N is smaller);
//   * per element d_i = z - w^i; a zero d_i (z hit the domain) becomes one,
//     so the chunk's product stays invertible, and its element is left out
//     of the sum;
//   * Montgomery's batch inversion within the chunk: prefix products to
//     scratch, one Fermat inversion of the chunk's product, then a
//     back-sweep that reads the prefixes and gives every d_i^-1;
//   * the thread sums p_i w^i d_i^-1 (p_i enters Montgomery form here, one
//     product by R^2); the block adds the partial sums in a shared tree;
//   * thread 0 forms z^N by log2 N squarings, then (z^N - 1) N^-1 sum, or
//     takes p_i where z hit w^i (at most one element can), and writes the
//     canonical plain value.
// Bound: 32-bit multiply-adds.  The least work is ~5 Fr products an
// element (3 for the batch inversion, 2 for p_i w^i d_i^-1); this design
// adds one conversion an element and one Fermat inversion (~380 products)
// a thread, about as much again at N = 4,096.  B <= 6 blocks leave most of
// the card's 132 SMs idle: splitting N across blocks is later work.
//
// In:  poly (B, N, 8) canonical plain words; z (B, 8) canonical plain;
//      roots (N, 8) w^0 .. w^(N-1) Montgomery; inv_n (8,) N^-1 Montgomery.
// Scratch: (B, N, 8) words (the chunks' prefix products).
// Out: y (B, 8) canonical plain words of p(z).
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include "fr.cuh"

#define KZG_THREADS 64

// d = z - w, with a zero difference replaced by one; returns the hit.
LH_DEV bool denominator(fr_t& d, const fr_t& zm, const uint32_t* root) {
  fr_t w;
  load(w, root);
  sub(d, zm, w);
  bool hit = is_zero(d);
  if (hit) set_one(d);
  return hit;
}

// One thread's share, elements [lo, hi): sets sum = sum of p_i w^i / d_i
// over the elements that are not a hit (Montgomery) and returns the index
// of a hit, or -1.
LH_NI int chunk_sum(fr_t& sum, const uint32_t* poly, const uint32_t* roots,
                    const fr_t& zm, int lo, int hi, uint32_t* scratch) {
  set_zero(sum);
  if (lo >= hi) return -1;
  int hit_at = -1;
  fr_t acc, d;
  set_one(acc);
  for (int i = lo; i < hi; i++) {
    if (denominator(d, zm, roots + 8 * (size_t)i)) hit_at = i;
    mul(acc, acc, d);
    store(scratch + 8 * (size_t)i, acc);
  }
  fr_t inv_acc;                      // 1 / (d_lo ... d_i), i from hi - 1
  inv(inv_acc, acc);
  for (int i = hi - 1; i >= lo; i--) {
    fr_t prev, dinv, p, w, term;
    if (i > lo) {
      load(prev, scratch + 8 * (size_t)(i - 1));
    } else {
      set_one(prev);
    }
    mul(dinv, inv_acc, prev);        // 1 / d_i
    denominator(d, zm, roots + 8 * (size_t)i);
    mul(inv_acc, inv_acc, d);
    if (i == hit_at) continue;
    load(p, poly + 8 * (size_t)i);
    to_mont(p, p);
    load(w, roots + 8 * (size_t)i);
    mul(term, p, w);
    mul(term, term, dinv);
    add(sum, sum, term);
  }
  return hit_at;
}

// Thread 0's close: y = (z^N - 1) N^-1 sum, or p_hit; canonical plain.
LH_NI void finish(uint32_t* y, const fr_t& sum, const fr_t& zm, int log_n,
                  const uint32_t* inv_n, const uint32_t* poly, int hit_at) {
  if (hit_at >= 0) {
    for (int k = 0; k < FR_NL; k++) y[k] = poly[8 * (size_t)hit_at + k];
    return;
  }
  fr_t zn = zm, one, num, in, out;
  for (int k = 0; k < log_n; k++) sqr(zn, zn);
  set_one(one);
  sub(num, zn, one);
  load(in, inv_n);
  mul(out, sum, num);
  mul(out, out, in);
  from_mont(out, out);
  store(y, out);
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(KZG_THREADS) k_blob_eval_kernel(
    const uint32_t* __restrict__ poly, const uint32_t* __restrict__ z,
    const uint32_t* __restrict__ roots, const uint32_t* __restrict__ inv_n,
    int n, int log_n, uint32_t* __restrict__ scratch,
    uint32_t* __restrict__ y) {
  __shared__ fr_t part[KZG_THREADS];
  __shared__ int hit_at;
  int b = blockIdx.x, t = threadIdx.x;
  if (t == 0) hit_at = -1;
  __syncthreads();
  const uint32_t* pb = poly + (size_t)b * n * 8;
  fr_t zm, sum;
  load(zm, z + 8 * (size_t)b);
  to_mont(zm, zm);
  int chunk = n >= KZG_THREADS ? n / KZG_THREADS : 1;
  int lo = t * chunk;
  int hi = lo + chunk < n ? lo + chunk : n;
  int h = chunk_sum(sum, pb, roots, zm, lo, hi, scratch + (size_t)b * n * 8);
  if (h >= 0) hit_at = h;            // at most one element can hit
  part[t] = sum;
  __syncthreads();
  for (int w = KZG_THREADS / 2; w > 0; w >>= 1) {
    if (t < w) {
      fr_t a = part[t];
      add(a, a, part[t + w]);
      part[t] = a;
    }
    __syncthreads();
  }
  if (t == 0) finish(y + 8 * (size_t)b, part[0], zm, log_n, inv_n, pb, hit_at);
}

extern "C" int k_blob_eval_launch(const void* poly, const void* z,
                                  const void* roots, const void* inv_n,
                                  int b, int n, int log_n, void* scratch,
                                  void* y, void* stream) {
  if (b <= 0) return 0;
  k_blob_eval_kernel<<<b, KZG_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)poly, (const uint32_t*)z, (const uint32_t*)roots,
      (const uint32_t*)inv_n, n, log_n, (uint32_t*)scratch, (uint32_t*)y);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
