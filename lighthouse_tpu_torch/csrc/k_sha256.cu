// The hash engine's four kernels: lane-parallel SHA-256 for SSZ
// merkleization and the shuffle.
//
// Replaces the JAX kernels of lighthouse_tpu/crypto/sha256/kernel.py:
//   k_pairs   :190  n 64-byte messages (LE words)  -> n digests (LE words)
//   k_entry   :162  n 64-byte messages (LE words)  -> n digest states
//   k_level   :175  2m digest states               -> m parent states
//   k_digest  :201  n padded m-block messages       -> n digests (LE words)
// A "state" is the 8 digest words as natural values: a level chain hashes
// on without a byte swap (the TPU kernel keeps it as (8, n), lanes minor,
// for its vector lanes; here it is (n, 8) rows in natural order, so lane j
// of k_level reads rows 2j and 2j+1 as 64 contiguous bytes, exactly the
// 16 message words of their parent).
//
// One thread a lane.  A pair hash is two compressions: the message block
// (schedule computed) and the constant padding block (K + W folded, no
// schedule).  Bound: 32-bit integer instructions, ~2,300 a pair hash
// (64 rounds of ~14 and 48 schedule steps of ~10 for the message block,
// 64 rounds for the padding block), against 96 bytes moved a pair; the
// body is unrolled and keeps the window, state and constants in registers.
// Loads and stores are 16 bytes a thread.
//
// Pointers must be 16-byte aligned (the wrappers check).  n and m may be
// any count: there is no lane padding.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include "sha256.cuh"

// One lane: the 16 words of a 64-byte message (little-endian loads when
// SWAP_IN, else natural values) -> the state of its hash.
template <bool SWAP_IN>
LH_SHA_DEV void pair_lane(const uint32_t in[16], uint32_t st[8]) {
  uint32_t blk[16];
#pragma unroll
  for (int k = 0; k < 16; k++) blk[k] = SWAP_IN ? sha_bswap(in[k]) : in[k];
#pragma unroll
  for (int k = 0; k < 8; k++) st[k] = LH_SHA_IV[k];
  sha256_block(st, blk);
  sha256_block_kw(st, LH_SHA_PAD64_KW);
}

// One block of k_digest: 16 little-endian loads of a padded block.
LH_SHA_DEV void digest_block(uint32_t st[8], const uint32_t in[16]) {
  uint32_t blk[16];
#pragma unroll
  for (int k = 0; k < 16; k++) blk[k] = sha_bswap(in[k]);
  sha256_block(st, blk);
}

#ifdef __CUDACC__
#define LH_SHA_THREADS 128

LH_SHA_DEV void load16(const uint4* src, uint32_t w[16]) {
#pragma unroll
  for (int q = 0; q < 4; q++) {
    uint4 v = __ldg(src + q);
    w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z; w[4 * q + 3] = v.w;
  }
}

LH_SHA_DEV void store8(uint4* dst, const uint32_t st[8], bool swap) {
  uint32_t o[8];
#pragma unroll
  for (int k = 0; k < 8; k++) o[k] = swap ? sha_bswap(st[k]) : st[k];
  dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
  dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// k_pairs: SWAP_IN, SWAP_OUT; k_entry: SWAP_IN only; k_level: neither.
template <bool SWAP_IN, bool SWAP_OUT>
__global__ void __launch_bounds__(LH_SHA_THREADS)
k_pair_hash_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                   int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t w[16], st[8];
  load16(in + 4 * (size_t)i, w);
  pair_lane<SWAP_IN>(w, st);
  store8(out + 2 * (size_t)i, st, SWAP_OUT);
}

__global__ void __launch_bounds__(LH_SHA_THREADS)
k_digest_kernel(const uint4* __restrict__ in, uint4* __restrict__ out, int n,
                int m) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint4* src = in + 4 * (size_t)m * i;
  uint32_t st[8];
#pragma unroll
  for (int k = 0; k < 8; k++) st[k] = LH_SHA_IV[k];
  for (int j = 0; j < m; j++) {
    uint32_t w[16];
    load16(src + 4 * j, w);
    digest_block(st, w);
  }
  store8(out + 2 * (size_t)i, st, true);
}

template <bool SWAP_IN, bool SWAP_OUT>
static int launch_pairs(const void* in, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  int blocks = (n + LH_SHA_THREADS - 1) / LH_SHA_THREADS;
  k_pair_hash_kernel<SWAP_IN, SWAP_OUT>
      <<<blocks, LH_SHA_THREADS, 0, (cudaStream_t)stream>>>(
          (const uint4*)in, (uint4*)out, n);
  return (int)cudaGetLastError();
}

// words (n, 16) LE -> digests (n, 8) LE words
extern "C" int k_pairs_launch(const void* words, void* out, int n,
                              void* stream) {
  return launch_pairs<true, true>(words, out, n, stream);
}

// words (n, 16) LE -> states (n, 8)
extern "C" int k_entry_launch(const void* words, void* out, int n,
                              void* stream) {
  return launch_pairs<true, false>(words, out, n, stream);
}

// states (2m, 8) -> states (m, 8)
extern "C" int k_level_launch(const void* state, void* out, int m,
                              void* stream) {
  return launch_pairs<false, false>(state, out, m, stream);
}

// blocks (n, m, 16) LE padded -> digests (n, 8) LE words
extern "C" int k_digest_launch(const void* blocks, void* out, int n, int m,
                               void* stream) {
  if (n <= 0) return 0;
  int b = (n + LH_SHA_THREADS - 1) / LH_SHA_THREADS;
  k_digest_kernel<<<b, LH_SHA_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)blocks, (uint4*)out, n, m);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
