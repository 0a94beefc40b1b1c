// k_subgroup: the subgroup checks of the monolithic batch kernels, and
// k_decode_g1: G1 decompression.
//
// k_subgroup replaces the check_subgroups branch of
// lighthouse_tpu/crypto/bls/tpu/verify.py verify_batch (:114-119) and
// verify_batch_multi (:160-170), the programs of tpu/backend.py:98
// _verify_batch_kernel and :106 _verify_batch_multi_kernel, and the checks
// of the sharded step (parallel/sharded_verify.py:129-130, ring.py:127-128).
// A block of G1 lanes and as many G2 lanes (check_coop.cuh ck_prog; one
// lane of each, or a few, below), the two groups as jobs of the same rounds
// of the point engine:
//   G1: phi(P) == [lambda] P, phi(x, y) = (beta x, y), lambda = z^2 - 1
//       (tpu/curve.py:608 g1_subgroup_check), run as phi(P) == [|z|]([|z|]
//       P) - P: two passes of the 64-bit |z| ladder and one addition;
//   G2: psi(Q) == [z] Q (tpu/curve.py:636 g2_subgroup_check: the |z|
//       ladder, beside the G1 lanes' first pass).
// A lane that is off (active 0) or infinity passes.  Each lane writes its
// byte; the AND of all lanes is set to 1 on the stream (cudaMemsetAsync)
// before the lanes run and a failing lane writes 0 (every writer writes the
// same value, so the race is benign).
// Bound: the latency of chains of Fp products (~555 rounds a block with a
// G1 lane, ~285 with G2 lanes only); the bytes are ~100 a lane.
//
// k_decode_g1 replaces tpu/curve.py:684 g1_decompress (and with `check`
// :608 g1_subgroup_check), which no device program of the reference calls
// (keys are decoded on the host into the arena in both packages).  A block
// of one lane, two or four (check_coop.cuh ck_prog in mode CK_DEC1, below),
// a lane: in one thread x to Montgomery form, y = (x^3 + 4)^((p + 1) / 4)
// by ck_pow with its square checked, the sign chosen on the real value of
// y (the Montgomery factor comes off first: a comparison of the Montgomery
// form negates y on about half the lanes), the affine point (x = y = 0 at
// infinity) and a lane verdict: "x == 0" on an infinity lane, "on the
// curve" elsewhere; with `check`, the lanes on the curve then run
// k_subgroup's G1 program as the block's jobs (phi(P) == [|z|]([|z|] P) -
// P), and their verdict is that check's.  Without `check` no round follows
// the decoding.
// Bound: the latency of one thread's power (~378 fsqr and ~75 fmul), then
// with `check` ~555 rounds a block; the bytes are ~100 a lane.
//
// k_subgroup in:  x1, y1 (n1, 12) affine Montgomery, inf1, act1 (n1,) uint8;
//                 x2, y2 (n2, 2, 12), inf2, act2 (n2,) uint8.
//             out: lanes (n1 + n2,) uint8, ok (1,) uint8.
// k_decode_g1 in: x (m, 12) canonical plain limbs, sign, inf (m,) uint8.
//             out: xs, ys (m, 12) affine Montgomery, si (m,), ok (m,) uint8.
// No launch needs a per-thread stack.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include "check_coop.cuh"

// k_subgroup's two layouts, chosen by the larger lane count as k_decode.cu
// chooses: a block of SUB_THREADS runs one G1 and one G2 lane while at
// most SUB_NARROW_PER_SM such blocks fall to an SM, a block of
// SUB_WIDE_THREADS runs SUB_WIDE_LANES of each beyond; others build with -D
// for a comparison (lighthouse_tpu_torch/tools/check_layouts.py).
#ifndef SUB_THREADS
#define SUB_THREADS 64
#endif
#ifndef SUB_WIDE_LANES
#define SUB_WIDE_LANES 2
#endif
#ifndef SUB_WIDE_THREADS
#define SUB_WIDE_THREADS 32
#endif
#ifndef SUB_NARROW_PER_SM
#define SUB_NARROW_PER_SM 4
#endif
// k_decode_g1's three layouts, chosen by its key count: a block of
// G1D_THREADS runs one key while at most G1D_NARROW_PER_SM keys fall to an
// SM; a block of G1D_WIDE_THREADS runs G1D_WIDE_LANES keys while at most
// G1D_WIDE_PER_SM fall to an SM (one wave of such blocks), and
// G1D_WIDER_LANES keys beyond, where the rounds of a block cost less than
// a second wave (the 4,096 arena keys; PERF.md, the k_decode_g1 layouts).
// The macros build with -D for a comparison
// (lighthouse_tpu_torch/tools/check_layouts.py).
constexpr int G1D_THREADS = 64;
constexpr int G1D_WIDE_LANES = 2;
#ifndef G1D_NARROW_PER_SM
#define G1D_NARROW_PER_SM 2
#endif
#ifndef G1D_WIDE_THREADS
#define G1D_WIDE_THREADS 32
#endif
#ifndef G1D_WIDE_PER_SM
#define G1D_WIDE_PER_SM 24
#endif
#ifndef G1D_WIDER_LANES
#define G1D_WIDER_LANES 4
#endif

#ifdef __CUDACC__
// The bound's minimum of one block an SM lets ptxas pass 128 registers
// (without it this kernel spilled at 128).
template <int L, int NT>
__global__ void __launch_bounds__(NT, 1) k_subgroup_kernel(
    const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
    const uint8_t* __restrict__ inf1, const uint8_t* __restrict__ act1,
    int n1, const uint32_t* __restrict__ x2, const uint32_t* __restrict__ y2,
    const uint8_t* __restrict__ inf2, const uint8_t* __restrict__ act2,
    int n2, uint8_t* __restrict__ lanes, uint8_t* __restrict__ ok) {
  __shared__ typename ck_prog<L, CK_SUB>::state_t s;
  lh_block<NT == 32 ? 32 : NT - 32, NT, lh_ptx> g{(int)threadIdx.x};
  ck_prog<L, CK_SUB> pr{s, {s.pc, 0, 0, false}, (int)blockIdx.x * L, x1,
                        y1, inf1, act1, n1, x2, y2, inf2, act2, n2, nullptr,
                        nullptr, nullptr, lanes, ok, 0, 0};
  lh_run(g, pr);
}

template <int L, int NT>
static void subgroup_blocks(const void* x1, const void* y1, const void* inf1,
                            const void* act1, int n1, const void* x2,
                            const void* y2, const void* inf2,
                            const void* act2, int n2, void* lanes, void* ok,
                            int m, cudaStream_t st) {
  k_subgroup_kernel<L, NT><<<(m + L - 1) / L, NT, 0, st>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint8_t*)inf1,
      (const uint8_t*)act1, n1, (const uint32_t*)x2, (const uint32_t*)y2,
      (const uint8_t*)inf2, (const uint8_t*)act2, n2, (uint8_t*)lanes,
      (uint8_t*)ok);
}

template <int L, int NT>
__global__ void __launch_bounds__(NT, 1) k_decode_g1_kernel(
    const uint32_t* __restrict__ x, const uint8_t* __restrict__ sign,
    const uint8_t* __restrict__ inf, int m, int check,
    uint32_t* __restrict__ xs, uint32_t* __restrict__ ys,
    uint8_t* __restrict__ si, uint8_t* __restrict__ ok) {
  __shared__ typename ck_prog<L, CK_DEC1>::state_t s;
  lh_block<NT == 32 ? 32 : NT - 32, NT, lh_ptx> g{(int)threadIdx.x};
  ck_prog<L, CK_DEC1> pr{s, {s.pc, 0, 0, false}, (int)blockIdx.x * L, x,
                         nullptr, inf, sign, m, nullptr, nullptr, nullptr,
                         nullptr, 0, xs, ys, si, ok, nullptr, 0, 0,
                         check != 0};
  lh_run(g, pr);
}

template <int L, int NT>
static void decode_g1_blocks(const void* x, const void* sign,
                             const void* inf, int m, int check, void* xs,
                             void* ys, void* si, void* ok, cudaStream_t st) {
  k_decode_g1_kernel<L, NT><<<(m + L - 1) / L, NT, 0, st>>>(
      (const uint32_t*)x, (const uint8_t*)sign, (const uint8_t*)inf, m,
      check, (uint32_t*)xs, (uint32_t*)ys, (uint8_t*)si, (uint8_t*)ok);
}

extern "C" int k_subgroup_launch(const void* x1, const void* y1,
                                 const void* inf1, const void* act1, int n1,
                                 const void* x2, const void* y2,
                                 const void* inf2, const void* act2, int n2,
                                 void* lanes, void* ok, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(ok, 1, 1, st);
  if (e != cudaSuccess) return (int)e;
  int m = n1 > n2 ? n1 : n2;
  if (m <= 0) return 0;
  bool narrow;
  e = ck_narrow(m, SUB_NARROW_PER_SM, narrow);
  if (e != cudaSuccess) return (int)e;
  if (narrow)
    subgroup_blocks<1, SUB_THREADS>(x1, y1, inf1, act1, n1, x2, y2, inf2,
                                    act2, n2, lanes, ok, m, st);
  else
    subgroup_blocks<SUB_WIDE_LANES, SUB_WIDE_THREADS>(
        x1, y1, inf1, act1, n1, x2, y2, inf2, act2, n2, lanes, ok, m, st);
  return (int)cudaGetLastError();
}

// Blocks an SM holds at once of k_subgroup's two layouts (out: a host
// pointer to two ints, the narrow layout's first).
extern "C" int k_subgroup_occupancy(int* out) {
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], k_subgroup_kernel<1, SUB_THREADS>, SUB_THREADS, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[1], k_subgroup_kernel<SUB_WIDE_LANES, SUB_WIDE_THREADS>,
        SUB_WIDE_THREADS, 0);
  return (int)e;
}

extern "C" int k_decode_g1_launch(const void* x, const void* sign,
                                  const void* inf, int m, int check, void* xs,
                                  void* ys, void* si, void* ok,
                                  void* stream) {
  if (m <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  bool narrow, wide;
  cudaError_t e = ck_narrow(m, G1D_NARROW_PER_SM, narrow);
  if (e == cudaSuccess) e = ck_narrow(m, G1D_WIDE_PER_SM, wide);
  if (e != cudaSuccess) return (int)e;
  if (narrow)
    decode_g1_blocks<1, G1D_THREADS>(x, sign, inf, m, check, xs, ys, si, ok,
                                     st);
  else if (wide)
    decode_g1_blocks<G1D_WIDE_LANES, G1D_WIDE_THREADS>(x, sign, inf, m, check,
                                                       xs, ys, si, ok, st);
  else
    decode_g1_blocks<G1D_WIDER_LANES, G1D_WIDE_THREADS>(
        x, sign, inf, m, check, xs, ys, si, ok, st);
  return (int)cudaGetLastError();
}

// Blocks an SM holds at once of k_decode_g1's three layouts (out: a host
// pointer to three ints, the narrow layout's first).
extern "C" int k_decode_g1_occupancy(int* out) {
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], k_decode_g1_kernel<1, G1D_THREADS>, G1D_THREADS, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[1], k_decode_g1_kernel<G1D_WIDE_LANES, G1D_WIDE_THREADS>,
        G1D_WIDE_THREADS, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], k_decode_g1_kernel<G1D_WIDER_LANES, G1D_WIDE_THREADS>,
        G1D_WIDE_THREADS, 0);
  return (int)e;
}
#endif  // __CUDACC__
