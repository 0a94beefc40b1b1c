// k_hash: hash-to-G2 of the field elements (u0, u1) -- simplified SWU on
// the 3-isogenous curve, the isogeny, the sum of both points, cofactor
// clearing and the affine conversion: H(m) as the pairing stage reads it.
//
// Replaces lighthouse_tpu/crypto/bls/tpu/staged.py:51 k_hash (an XLA program
// over hash_to_g2.hash_to_g2_device + curve.to_affine).  Two threads a
// message run the lane machine of hash_g2.cuh (LH_S_HASH): one map each,
// the swap, the sum and cofactor clearing on both, one binary-Euclid
// inversion for the affine point; the even thread stores.  Bound: the
// latency of chains of dependent Fp products (~5,000 a thread); the bytes
// moved (192 in, 196 out a message) are negligible.  Blocks of 32 threads
// (16 messages) spread a batch over as many SMs as it has warps.
//
// In:  u (n, 2, 2, 12) plain canonical limbs.
// Out: hx, hy (n, 2, 12) Montgomery canonical, hinf (n,) uint8.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include "hash_g2.cuh"

#define HASH_THREADS 32

// One thread of a message pair after its machine ran: the even thread
// stores the affine point (T4, T5) and the infinity flag.
LH_MEM void hash_store(lh_vm& vm, uint32_t* hx, uint32_t* hy,
                       uint8_t* hinf) {
  fp2_t x, y, z;
  vm.ld(x, T4);
  vm.ld(y, T5);
  vm.ld(z, PA + 2);
  store(hx, x);
  store(hy, y);
  *hinf = is_zero(z) ? 1 : 0;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(HASH_THREADS)
    k_hash_kernel(const uint32_t* __restrict__ u, uint32_t* __restrict__ hx,
                  uint32_t* __restrict__ hy, uint8_t* __restrict__ hinf,
                  int n) {
  extern __shared__ uint32_t lh_smem[];
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int msg = g >> 1;
  const bool live = msg < n;
  lh_vm vm;
  vm.init(lh_smem, blockDim.x, threadIdx.x, S_HASH);
  // a masked-off thread maps message 0's element and stores nothing
  vm.load_u(u + 48 * (size_t)(live ? msg : 0) + 24 * (g & 1));
  for (;;) {                         // LH_S_HASH, the inverse, LH_S_AFF
    while (vm.run()) __syncwarp();
    if (vm.script == S_AFF) break;
    lh_invert_norm(vm);
    vm.start(S_AFF);
  }
  if (live && !(g & 1))
    hash_store(vm, hx + 24 * (size_t)msg, hy + 24 * (size_t)msg, hinf + msg);
}

extern "C" int k_hash_launch(const void* u, void* hx, void* hy, void* hinf,
                             int n, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = lh_vm_smem(LH_HASH_SLOTS, HASH_THREADS);
  cudaError_t e = cudaFuncSetAttribute(
      k_hash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (2 * n + HASH_THREADS - 1) / HASH_THREADS;
  k_hash_kernel<<<blocks, HASH_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)u, (uint32_t*)hx, (uint32_t*)hy, (uint8_t*)hinf, n);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
