// k_subgroup: the subgroup checks of the monolithic batch kernels, and
// k_decode_g1: G1 decompression.
//
// k_subgroup replaces the check_subgroups branch of
// lighthouse_tpu/crypto/bls/tpu/verify.py verify_batch (:114-119) and
// verify_batch_multi (:160-170), the programs of tpu/backend.py:98
// _verify_batch_kernel and :106 _verify_batch_multi_kernel, and the checks
// of the sharded step (parallel/sharded_verify.py:129-130, ring.py:127-128).
// One thread a lane over n1 G1 lanes, then n2 G2 lanes:
//   G1: phi(P) == [lambda] P, phi(x, y) = (beta x, y), lambda = z^2 - 1
//       (tpu/curve.py:608 g1_subgroup_check: a 128-bit ladder);
//   G2: psi(Q) == [z] Q (tpu/curve.py:636 g2_subgroup_check: 64 bits).
// A lane that is off (active 0) or infinity passes.  Each lane writes its
// byte; the AND of all lanes is set to 1 on the stream (cudaMemsetAsync)
// before the lanes run and a failing lane writes 0 (every writer writes the
// same value, so the race is benign).
// Bound: 32-bit multiply-adds, ~1,500 Fp products a G1 lane and ~2,200 a G2
// lane; the bytes are ~100 a lane.
//
// k_decode_g1 replaces tpu/curve.py:684 g1_decompress, which no device
// program of the reference calls (keys are decoded on the host into the
// arena in both packages).  One thread a lane: x to Montgomery form,
// y = (x^3 + 4)^((p + 1) / 4) with its square checked, the sign chosen on
// the real value of y (the Montgomery factor comes off first: a comparison
// of the Montgomery form negates y on about half the lanes), the affine
// point (x = y = 0 at infinity), and a lane verdict: "x == 0" on an
// infinity lane, "on the curve" elsewhere, and with `check` also the G1
// subgroup check.
// Bound: 32-bit multiply-adds, ~450 Fp products a lane for the square root
// (plus the subgroup ladder with `check`).
//
// k_subgroup in:  x1, y1 (n1, 12) affine Montgomery, inf1, act1 (n1,) uint8;
//                 x2, y2 (n2, 2, 12), inf2, act2 (n2,) uint8.
//             out: lanes (n1 + n2,) uint8, ok (1,) uint8.
// k_decode_g1 in: x (m, 12) canonical plain limbs, sign, inf (m,) uint8.
//             out: xs, ys (m, 12) affine Montgomery, si (m,), ok (m,) uint8.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include "bls12_381.cuh"

// One G1 lane of k_subgroup.
LH_NI bool subgroup_g1_lane(const uint32_t* x, const uint32_t* y, bool inf,
                            bool active) {
  if (!active || inf) return true;
  fp_t ax, ay;
  load(ax, x);
  load(ay, y);
  g1_t p;
  pt_from_affine(p, ax, ay, false);
  return g1_subgroup_check(p);
}

// One G2 lane of k_subgroup.
LH_NI bool subgroup_g2_lane(const uint32_t* x, const uint32_t* y, bool inf,
                            bool active) {
  if (!active || inf) return true;
  fp2_t ax, ay;
  load(ax, x);
  load(ay, y);
  g2_t p;
  pt_from_affine(p, ax, ay, false);
  return g2_subgroup_check(p);
}

// One lane of k_decode_g1: writes the affine point and returns the lane
// verdict.
LH_NI bool decode_g1_lane(const uint32_t* x, bool sign, bool inf, bool check,
                          uint32_t* xs, uint32_t* ys) {
  fp_t xw, ax, ay;
  load(xw, x);
  g1_t pt;
  bool ok = g1_decompress(pt, xw, sign, inf);
  ok = ok && (inf || !check || g1_subgroup_check(pt));
  if (inf) {
    set_zero(ax);
    set_zero(ay);
  } else {
    ax = pt.x;
    ay = pt.y;
  }
  store(xs, ax);
  store(ys, ay);
  return ok;
}

#ifdef __CUDACC__
__global__ void k_subgroup_kernel(
    const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
    const uint8_t* __restrict__ inf1, const uint8_t* __restrict__ act1,
    int n1, const uint32_t* __restrict__ x2, const uint32_t* __restrict__ y2,
    const uint8_t* __restrict__ inf2, const uint8_t* __restrict__ act2,
    int n2, uint8_t* __restrict__ lanes, uint8_t* __restrict__ ok) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n1 + n2) return;
  bool pass;
  if (i < n1) {
    pass = subgroup_g1_lane(x1 + 12 * (size_t)i, y1 + 12 * (size_t)i,
                            inf1[i], act1[i]);
  } else {
    int j = i - n1;
    pass = subgroup_g2_lane(x2 + 24 * (size_t)j, y2 + 24 * (size_t)j,
                            inf2[j], act2[j]);
  }
  lanes[i] = pass ? 1 : 0;
  if (!pass) ok[0] = 0;
}

__global__ void k_decode_g1_kernel(const uint32_t* __restrict__ x,
                                   const uint8_t* __restrict__ sign,
                                   const uint8_t* __restrict__ inf, int m,
                                   int check, uint32_t* __restrict__ xs,
                                   uint32_t* __restrict__ ys,
                                   uint8_t* __restrict__ si,
                                   uint8_t* __restrict__ ok) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  bool lane_inf = inf[i];
  ok[i] = decode_g1_lane(x + 12 * (size_t)i, sign[i], lane_inf, check != 0,
                         xs + 12 * (size_t)i, ys + 12 * (size_t)i) ? 1 : 0;
  si[i] = lane_inf ? 1 : 0;
}

extern "C" int k_subgroup_launch(const void* x1, const void* y1,
                                 const void* inf1, const void* act1, int n1,
                                 const void* x2, const void* y2,
                                 const void* inf2, const void* act2, int n2,
                                 void* lanes, void* ok, void* stream) {
  cudaError_t e = lh_ensure_stack(LH_STACK_BYTES);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  e = cudaMemsetAsync(ok, 1, 1, st);
  if (e != cudaSuccess) return (int)e;
  int m = n1 + n2;
  if (m <= 0) return 0;
  int threads = 32;
  int blocks = (m + threads - 1) / threads;
  k_subgroup_kernel<<<blocks, threads, 0, st>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint8_t*)inf1,
      (const uint8_t*)act1, n1, (const uint32_t*)x2, (const uint32_t*)y2,
      (const uint8_t*)inf2, (const uint8_t*)act2, n2, (uint8_t*)lanes,
      (uint8_t*)ok);
  return (int)cudaGetLastError();
}

extern "C" int k_decode_g1_launch(const void* x, const void* sign,
                                  const void* inf, int m, int check, void* xs,
                                  void* ys, void* si, void* ok,
                                  void* stream) {
  if (m <= 0) return 0;
  cudaError_t e = lh_ensure_stack(LH_STACK_BYTES);
  if (e != cudaSuccess) return (int)e;
  int threads = 32;
  int blocks = (m + threads - 1) / threads;
  k_decode_g1_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint8_t*)sign, (const uint8_t*)inf, m, check,
      (uint32_t*)xs, (uint32_t*)ys, (uint8_t*)si, (uint8_t*)ok);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
