// k_decode: on-card deserialization of wire G2 signatures, and k_and, the
// verdict combiner.
//
// k_decode replaces lighthouse_tpu/crypto/bls/tpu/staged.py:66 k_decode (an
// XLA program over curve.g2_decompress, curve.g2_subgroup_check and
// curve.to_affine).  The host parses the 96 wire bytes into flags and the
// canonical limbs of x (cuda/backend.py parse_g2_compressed_many); a block
// of one lane or a few (check_coop.cuh ck_prog, below) then runs, a lane:
//   y = sqrt(x^3 + 4(1 + u)) by the norm trick, its three powers by
//   (p - 3) / 4 in one thread each (the last two side by side), the sign
//   choice on the real value of y, and the subgroup check psi(P) ==
//   -[|z|] P as rounds of the point engine (points_coop.cuh) and a
//   projective compare; it writes the affine Montgomery point (Z is 1 or
//   0, so no inversion is needed).
// The all-lanes verdict ok is set to 1 on the stream (cudaMemsetAsync)
// before the kernel runs; a lane that is off the curve, outside the
// subgroup, or a malformed infinity writes 0 (every writer writes the same
// value, so the race is benign).
// Bound: the latency of chains of Fp products (two dependent powers of
// ~450 products, then ~280 rounds of the ladder a block); the bytes are
// ~250 a lane.  No launch needs a per-thread stack.
//
// k_and replaces staged.py:81 k_and: one thread ANDs two device verdicts,
// so the wire path reads back one byte.
//
// In:  x (m, 2, 12) canonical plain limbs; sign, inf (m,) uint8.
// Out: xs, ys (m, 2, 12) affine Montgomery; si (m,) uint8; ok (1,) uint8.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include "check_coop.cuh"

// Two layouts, chosen by the lane count; others build with -D for a
// comparison (lighthouse_tpu_torch/tools/check_layouts.py).  While at most
// DEC_NARROW_PER_SM lanes fall to an SM (the 64-set gossip batch) a block
// of DEC_THREADS threads runs one lane, so each lane's chain has most of an
// SM; beyond, a block of DEC_WIDE_THREADS runs DEC_WIDE_LANES lanes, so a
// 1,025-lane batch fits the card in one wave.  A block of 32 threads runs a
// round's products, then its sums; a larger one gives its last warp the
// sums.
#ifndef DEC_THREADS
#define DEC_THREADS 64
#endif
#ifndef DEC_WIDE_LANES
#define DEC_WIDE_LANES 2
#endif
#ifndef DEC_WIDE_THREADS
#define DEC_WIDE_THREADS 32
#endif
#ifndef DEC_NARROW_PER_SM
#define DEC_NARROW_PER_SM 2
#endif

#ifdef __CUDACC__
template <int L, int NT>
__global__ void __launch_bounds__(NT, 1) k_decode_kernel(
    const uint32_t* __restrict__ x, const uint8_t* __restrict__ sign,
    const uint8_t* __restrict__ inf, uint32_t* __restrict__ xs,
    uint32_t* __restrict__ ys, uint8_t* __restrict__ si,
    uint8_t* __restrict__ ok, int m) {
  __shared__ typename ck_prog<L, CK_DEC>::state_t s;
  lh_block<NT == 32 ? 32 : NT - 32, NT, lh_ptx> g{(int)threadIdx.x};
  ck_prog<L, CK_DEC> pr{s, {s.pc, 0, 0, false}, (int)blockIdx.x * L, x,
                        nullptr, inf, sign, m, nullptr, nullptr, nullptr,
                        nullptr, 0, xs, ys, si, nullptr, ok, 0, 0};
  lh_run(g, pr);
}

template <int L, int NT>
static void decode_blocks(const void* x, const void* sign, const void* inf,
                          int m, void* xs, void* ys, void* si, void* ok,
                          cudaStream_t st) {
  k_decode_kernel<L, NT><<<(m + L - 1) / L, NT, 0, st>>>(
      (const uint32_t*)x, (const uint8_t*)sign, (const uint8_t*)inf,
      (uint32_t*)xs, (uint32_t*)ys, (uint8_t*)si, (uint8_t*)ok, m);
}

__global__ void k_and_kernel(const uint8_t* __restrict__ a,
                             const uint8_t* __restrict__ b,
                             uint8_t* __restrict__ out) {
  out[0] = (a[0] && b[0]) ? 1 : 0;
}

extern "C" int k_decode_launch(const void* x, const void* sign,
                               const void* inf, int m, void* xs, void* ys,
                               void* si, void* ok, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(ok, 1, 1, st);  // no lane: true
  if (e != cudaSuccess || m <= 0) return (int)e;
  bool narrow;
  e = ck_narrow(m, DEC_NARROW_PER_SM, narrow);
  if (e != cudaSuccess) return (int)e;
  if (narrow)
    decode_blocks<1, DEC_THREADS>(x, sign, inf, m, xs, ys, si, ok, st);
  else
    decode_blocks<DEC_WIDE_LANES, DEC_WIDE_THREADS>(x, sign, inf, m, xs, ys,
                                                    si, ok, st);
  return (int)cudaGetLastError();
}

// Blocks an SM holds at once of the two layouts (out: a host pointer to
// two ints, the narrow layout's first).
extern "C" int k_decode_occupancy(int* out) {
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], k_decode_kernel<1, DEC_THREADS>, DEC_THREADS, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[1], k_decode_kernel<DEC_WIDE_LANES, DEC_WIDE_THREADS>,
        DEC_WIDE_THREADS, 0);
  return (int)e;
}

extern "C" int k_and_launch(const void* a, const void* b, void* out,
                            void* stream) {
  k_and_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)a, (const uint8_t*)b, (uint8_t*)out);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
