// k_sign: batched duty signing on the card, and the aggregate-and-proof sum.
//
// k_sign_root replaces lighthouse_tpu/crypto/bls/tpu/signer.py:113
// k_sign_root, k_sign_field replaces signer.py:122 k_sign_field and
// k_sign_agg replaces signer.py:143 k_sign_agg (with aggregate_points_g2,
// :129) -- XLA programs over hash_to_g2, curve.ladder_step scanned over 255
// scalar bits (_ladder_compress, :91), curve.g2_decompress, curve.sum_reduce
// and curve.to_affine.
//
// k_sign_root / k_sign_field: two threads a lane run the lane machine of
// hash_g2.cuh (LH_S_SIGN): (for a 32-byte root, on both threads)
// expand_message_xmd of xmd.cuh, the two-thread hash to G2 (H stays
// Jacobian), the psi-split ladder -- the even thread the digits (d0, d1)
// of k mod r in base |z| over {inf, H, -psi H, H - psi H}, the odd one (d2,
// d3) over the psi^2 images, 64 steps of a doubling and a complete
// addition each -- one complete addition joining the halves, and
// g2_compress's planes (Fermat 1/Z: canonical plain affine x, the
// lexicographic sign of y, the infinity flag); the even thread stores.
// CONSTANT SEQUENCE: nothing in a lane's instruction stream depends on its
// scalar.  k mod r is one masked subtraction, the digits come from fixed
// shift-and-subtract divisions by the constant |z|, every ladder step
// doubles, reads all three table entries and their doubles under masks and
// adds, the addition's infinity and P == +-Q cases are settled by masks,
// and the compression has no branch on the point (1/Z of infinity is 0 by
// Fermat).  The hash depends on the message only.  The zero scalar of a
// padding row gives infinity, which compresses to (x = 0, sign = 0, inf =
// 1).  Bound: the latency of chains of dependent Fp products (~9,000 a
// thread); the bytes moved (~130 a lane) are negligible.
//
// k_sign_agg: two launches.
//   1. one thread per (row, lane) decompresses a wire signature WITHOUT a
//      subgroup check (curve.g2_decompress semantics: y of the wire's sign,
//      ok = on the curve, or x == 0 for an infinity flag) into a Jacobian
//      point in scratch; a masked-off or infinity lane contributes infinity.
//      ok (m,) is set to 1 on the stream first, and a live lane that fails
//      writes 0 into its row's byte (every writer writes 0: the race is
//      benign), so ok[row] = all(ok | ~mask).
//   2. one block per row sums its k points in place with complete additions
//      (a repeated signature doubles, sigma + (-sigma) is infinity) in the
//      halving tree of curve.sum_reduce -- pairs (a, a + s) at stride s --
//      so the plain version's order is the kernel's (a sum that holds an
//      off-curve point is then still the same bits), and its first thread
//      compresses the row's sum.
// Signatures are public: these additions may branch.  Bound: 32-bit
// multiply-adds (the square root of each lane, ~1,100 Fp products, then
// k - 1 additions a row).
//
// k_sign_root in: w (n, 8) uint32 scalar words, msg (n, 8) big-endian words.
// k_sign_field in: w (n, 8), u (n, 2, 2, 12) canonical plain limbs.
// Both out: x (n, 2, 12) canonical plain limbs, sign (n,), inf (n,) uint8.
// k_sign_agg in: x (m, k, 2, 12) canonical plain limbs; sign, inf, mask
// (m, k) uint8; scratch jac (m k, 72 words).  Out: x (m, 2, 12), sign, inf,
// ok (m,) uint8.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include "hash_g2.cuh"
#include "xmd.cuh"

#define SIGN_THREADS 32

// The compressed planes of a lane after LH_S_SIGN: x = T5 (plain), the
// lexicographic sign of y = T6 (plain), and whether the sum at PA is
// infinity; the even thread stores them.
LH_MEM void sign_store(lh_vm& vm, uint32_t* x, uint8_t* sign,
                       uint8_t* inf) {
  fp2_t xo, y, z;
  vm.ld(xo, T5);
  vm.ld(y, T6);
  vm.ld(z, PA + 2);
  store(x, xo);
  const bool c1z = is_zero(y.c1);
  *sign = (uint8_t)((c1z & gt_half_p(y.c0)) | (!c1z & gt_half_p(y.c1)));
  *inf = (uint8_t)is_zero(z);
}

// Launch 1 of k_sign_agg, one lane: returns whether it passes (a masked-off
// lane always does).
LH_NI bool agg_decode_lane(const uint32_t* x, bool sign, bool inf, bool live,
                           uint32_t* jac) {
  fp2_t xw;
  load(xw, x);
  g2_t pt;
  bool ok = g2_decompress(pt, xw, sign, inf);
  if (!live) set_zero(pt.z);
  store_words(jac, pt);
  return ok || !live;
}

// Launch 2 of k_sign_agg, the pairs of one tree level for thread t of nt.
LH_NI void agg_level(uint32_t* jac, int k, int s, int t, int nt) {
  for (int a = 2 * s * t; a + s < k; a += 2 * s * nt) {
    g2_t p, q;
    load_words(p, jac + 72 * (size_t)a);
    load_words(q, jac + 72 * (size_t)(a + s));
    pt_add(p, p, q);
    store_words(jac + 72 * (size_t)a, p);
  }
}

// The compressed planes of one row's sum (infinity for k = 0).
LH_NI void agg_compress(const uint32_t* jac, int k, uint32_t* x,
                        uint8_t* sign, uint8_t* inf) {
  g2_t p;
  if (k > 0) {
    load_words(p, jac);
  } else {
    pt_set_inf(p);
  }
  fp2_t xo;
  bool sg, in;
  g2_compress(xo, sg, in, p);
  store(x, xo);
  *sign = (uint8_t)sg;
  *inf = (uint8_t)in;
}

#ifdef __CUDACC__
#define AGG_TREE_THREADS 128

__global__ void __launch_bounds__(SIGN_THREADS)
    k_sign_root_kernel(const uint32_t* __restrict__ w,
                       const uint32_t* __restrict__ msg,
                       uint32_t* __restrict__ x, uint8_t* __restrict__ sign,
                       uint8_t* __restrict__ inf, int n) {
  extern __shared__ uint32_t lh_smem[];
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = g >> 1;
  const bool live = lane < n;
  const int src = live ? lane : 0;   // a masked-off thread runs lane 0
  lh_vm vm;
  vm.init(lh_smem, blockDim.x, threadIdx.x, S_SIGN);
  {
    uint32_t u[48];
    xmd_lane(msg + 8 * (size_t)src, u);
    vm.load_u(u + 24 * (g & 1));
  }
  vm.load_scalar(w + 8 * (size_t)src);
  while (vm.run()) __syncwarp();
  if (live && !(g & 1))
    sign_store(vm, x + 24 * (size_t)lane, sign + lane, inf + lane);
}

__global__ void __launch_bounds__(SIGN_THREADS)
    k_sign_field_kernel(const uint32_t* __restrict__ w,
                        const uint32_t* __restrict__ u,
                        uint32_t* __restrict__ x, uint8_t* __restrict__ sign,
                        uint8_t* __restrict__ inf, int n) {
  extern __shared__ uint32_t lh_smem[];
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = g >> 1;
  const bool live = lane < n;
  const int src = live ? lane : 0;
  lh_vm vm;
  vm.init(lh_smem, blockDim.x, threadIdx.x, S_SIGN);
  vm.load_u(u + 48 * (size_t)src + 24 * (g & 1));
  vm.load_scalar(w + 8 * (size_t)src);
  while (vm.run()) __syncwarp();
  if (live && !(g & 1))
    sign_store(vm, x + 24 * (size_t)lane, sign + lane, inf + lane);
}

__global__ void k_sign_agg_decode_kernel(const uint32_t* __restrict__ x,
                                         const uint8_t* __restrict__ sign,
                                         const uint8_t* __restrict__ inf,
                                         const uint8_t* __restrict__ mask,
                                         uint32_t* __restrict__ jac,
                                         uint8_t* __restrict__ ok, int m,
                                         int k) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m * k) return;
  bool good = agg_decode_lane(x + 24 * (size_t)i, sign[i] != 0, inf[i] != 0,
                              mask[i] != 0, jac + 72 * (size_t)i);
  if (!good) ok[i / k] = 0;
}

__global__ void k_sign_agg_sum_kernel(uint32_t* __restrict__ jac, int k,
                                      uint32_t* __restrict__ x,
                                      uint8_t* __restrict__ sign,
                                      uint8_t* __restrict__ inf) {
  int row = blockIdx.x, t = threadIdx.x;
  uint32_t* rj = jac + 72 * (size_t)row * k;
  for (int s = 1; s < k; s <<= 1) {
    agg_level(rj, k, s, t, AGG_TREE_THREADS);
    __syncthreads();
  }
  if (t == 0)
    agg_compress(rj, k, x + 24 * (size_t)row, sign + row, inf + row);
}

static int lanes_blocks(int n, int threads) {
  return (n + threads - 1) / threads;
}

template <class K>
static int sign_launch(K kernel, const void* w, const void* data, int n,
                       void* x, void* sign, void* inf, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = lh_vm_smem(LH_SIGN_SLOTS, SIGN_THREADS);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  kernel<<<lanes_blocks(2 * n, SIGN_THREADS), SIGN_THREADS, smem,
           (cudaStream_t)stream>>>(
      (const uint32_t*)w, (const uint32_t*)data, (uint32_t*)x,
      (uint8_t*)sign, (uint8_t*)inf, n);
  return (int)cudaGetLastError();
}

extern "C" int k_sign_root_launch(const void* w, const void* msg, int n,
                                  void* x, void* sign, void* inf,
                                  void* stream) {
  return sign_launch(k_sign_root_kernel, w, msg, n, x, sign, inf, stream);
}

extern "C" int k_sign_field_launch(const void* w, const void* u, int n,
                                   void* x, void* sign, void* inf,
                                   void* stream) {
  return sign_launch(k_sign_field_kernel, w, u, n, x, sign, inf, stream);
}

extern "C" int k_sign_agg_launch(const void* xin, const void* sin,
                                 const void* iin, const void* mask, int m,
                                 int k, void* jac, void* x, void* sign,
                                 void* inf, void* ok, void* stream) {
  if (m <= 0) return 0;
  cudaError_t e = lh_ensure_stack(LH_STACK_BYTES);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  e = cudaMemsetAsync(ok, 1, (size_t)m, st);   // AND over no lane is true
  if (e != cudaSuccess) return (int)e;
  if (k > 0) {
    k_sign_agg_decode_kernel<<<lanes_blocks(m * k, 32), 32, 0, st>>>(
        (const uint32_t*)xin, (const uint8_t*)sin, (const uint8_t*)iin,
        (const uint8_t*)mask, (uint32_t*)jac, (uint8_t*)ok, m, k);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  k_sign_agg_sum_kernel<<<m, AGG_TREE_THREADS, 0, st>>>(
      (uint32_t*)jac, k, (uint32_t*)x, (uint8_t*)sign, (uint8_t*)inf);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
