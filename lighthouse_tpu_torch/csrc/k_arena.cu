// The pubkey arena on the card: dirty-row scatter and per-batch row gather.
//
// k_scatter_rows replaces lighthouse_tpu/crypto/bls/tpu/pubkey_cache.py:74
// _scatter_rows (arr.at[idx].set(vals)); k_gather_rows replaces the row
// gather of parallel/sharded_verify.py:374-375 (jnp.take of the arena by
// row index).  The arena is (rows, 12) uint32 x and y, Montgomery limbs of
// affine G1 keys; row 0 is the infinity / padding row.
//
// Both are pure data movement: the bound is bytes.  A row is 48 bytes, three
// 16-byte words, so one thread moves one 16-byte word of x and of y and
// neighbouring threads touch neighbouring addresses.  The scatter writes the
// arena in place; an index repeated in one call must carry the same values
// (the arena's sync never repeats one).  A row index outside [0, rows) is
// a fault of the caller (the rows come from the cache under its lock): the
// kernel traps before it touches memory, so the launch fails and the next
// synchronising call on the stream raises, as the plain versions raise on
// it, instead of reading or dropping a key in silence.  Every pointer is
// 16-byte aligned (the wrappers check).
//
// Scatter in: ax, ay (rows, 12) in-out; idx (d,) int64; vx, vy (d, 12).
// Gather in: ax, ay; rows (m,) int64.  Out: x, y (m, 12); inf (m,) uint8.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <stdint.h>

#define ROW_WORDS 3                  // 16-byte words a 12-limb row

#ifdef __CUDACC__
__global__ void k_scatter_rows_kernel(uint4* __restrict__ ax,
                                      uint4* __restrict__ ay,
                                      const int64_t* __restrict__ idx,
                                      const uint4* __restrict__ vx,
                                      const uint4* __restrict__ vy, int d,
                                      int64_t rows) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= d * ROW_WORDS) return;
  int64_t r = idx[t / ROW_WORDS];
  if (r < 0 || r >= rows) __trap();
  size_t dst = (size_t)r * ROW_WORDS + t % ROW_WORDS;
  ax[dst] = vx[t];
  ay[dst] = vy[t];
}

__global__ void k_gather_rows_kernel(const uint4* __restrict__ ax,
                                     const uint4* __restrict__ ay,
                                     const int64_t* __restrict__ rows_in,
                                     uint4* __restrict__ x,
                                     uint4* __restrict__ y,
                                     uint8_t* __restrict__ inf, int m,
                                     int64_t rows) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= m * ROW_WORDS) return;
  int j = t / ROW_WORDS;
  int64_t r = rows_in[j];
  if (r < 0 || r >= rows) __trap();
  size_t src = (size_t)r * ROW_WORDS + t % ROW_WORDS;
  x[t] = ax[src];
  y[t] = ay[src];
  if (t % ROW_WORDS == 0) inf[j] = r == 0 ? 1 : 0;
}

static int blocks_for(int work, int threads) {
  return (work + threads - 1) / threads;
}

extern "C" int k_scatter_rows_launch(void* ax, void* ay, int rows,
                                     const void* idx, const void* vx,
                                     const void* vy, int d, void* stream) {
  if (d <= 0) return 0;
  k_scatter_rows_kernel<<<blocks_for(d * ROW_WORDS, 256), 256, 0,
                          (cudaStream_t)stream>>>(
      (uint4*)ax, (uint4*)ay, (const int64_t*)idx, (const uint4*)vx,
      (const uint4*)vy, d, (int64_t)rows);
  return (int)cudaGetLastError();
}

extern "C" int k_gather_rows_launch(const void* ax, const void* ay, int rows,
                                    const void* rows_in, int m, void* x,
                                    void* y, void* inf, void* stream) {
  if (m <= 0) return 0;
  k_gather_rows_kernel<<<blocks_for(m * ROW_WORDS, 256), 256, 0,
                         (cudaStream_t)stream>>>(
      (const uint4*)ax, (const uint4*)ay, (const int64_t*)rows_in,
      (uint4*)x, (uint4*)y, (uint8_t*)inf, m, (int64_t)rows);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
