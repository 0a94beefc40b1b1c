// The arenas on the card: dirty-row scatter and per-batch row gather, for
// the pubkey arena (verification) and the secret-key arena (signing).
//
// Pubkey arena: k_scatter_rows replaces
// lighthouse_tpu/crypto/bls/tpu/pubkey_cache.py:74 _scatter_rows
// (arr.at[idx].set(vals)); k_gather_rows replaces the row gather of
// parallel/sharded_verify.py:374-375 (jnp.take of the arena by row index).
// That arena is (rows, 12) uint32 x and y, Montgomery limbs of affine G1
// keys; row 0 is the infinity / padding row.
//
// Secret-key arena: k_scatter_sk_rows replaces tpu/seckey_cache.py:67
// _scatter_rows and k_gather_sk_rows replaces tpu/signer.py:229 gather_rows
// (jnp.take).  That arena is (rows, 8) uint32, the little-endian words of
// each secret scalar; row 0 is the zero scalar of padding lanes.
//
// All four are pure data movement: the bound is bytes.  One kernel template
// serves both arenas: a row is W 16-byte words (3 for a 12-limb row, 2 for
// an 8-word scalar), one thread moves one 16-byte word of each plane, and
// neighbouring threads touch neighbouring addresses.  The scatter writes
// the arena in place; an index repeated in one call must carry the same
// values (the arenas' syncs never repeat one).  A row index outside
// [0, rows) is a fault of the caller (the rows come from a cache under its
// lock): the kernel traps before it touches memory, so the launch fails and
// the next synchronising call on the stream raises, as the plain versions
// raise on it, instead of reading or dropping a row in silence.  Every
// pointer is 16-byte aligned (the wrappers check).
//
// Pubkey scatter in: ax, ay (rows, 12) in-out; idx (d,) int64; vx, vy
// (d, 12).  Pubkey gather in: ax, ay; rows (m,) int64.  Out: x, y (m, 12);
// inf (m,) uint8.  Secret scatter in: a (rows, 8) in-out; idx (d,); v
// (d, 8).  Secret gather in: a; rows (m,).  Out: w (m, 8).
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <stdint.h>

#ifdef __CUDACC__
// Planes b / vb and the flags inf are optional (NULL).
template <int W>
__global__ void scatter_rows_kernel(uint4* __restrict__ a,
                                    uint4* __restrict__ b,
                                    const int64_t* __restrict__ idx,
                                    const uint4* __restrict__ va,
                                    const uint4* __restrict__ vb, int d,
                                    int64_t rows) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= d * W) return;
  int64_t r = idx[t / W];
  if (r < 0 || r >= rows) __trap();
  size_t dst = (size_t)r * W + t % W;
  a[dst] = va[t];
  if (b) b[dst] = vb[t];
}

template <int W>
__global__ void gather_rows_kernel(const uint4* __restrict__ a,
                                   const uint4* __restrict__ b,
                                   const int64_t* __restrict__ rows_in,
                                   uint4* __restrict__ x,
                                   uint4* __restrict__ y,
                                   uint8_t* __restrict__ inf, int m,
                                   int64_t rows) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= m * W) return;
  int j = t / W;
  int64_t r = rows_in[j];
  if (r < 0 || r >= rows) __trap();
  size_t src = (size_t)r * W + t % W;
  x[t] = a[src];
  if (b) y[t] = b[src];
  if (inf && t % W == 0) inf[j] = r == 0 ? 1 : 0;
}

static int blocks_for(int work, int threads) {
  return (work + threads - 1) / threads;
}

template <int W>
static int scatter_launch(void* a, void* b, int rows, const void* idx,
                          const void* va, const void* vb, int d,
                          void* stream) {
  if (d <= 0) return 0;
  scatter_rows_kernel<W><<<blocks_for(d * W, 256), 256, 0,
                           (cudaStream_t)stream>>>(
      (uint4*)a, (uint4*)b, (const int64_t*)idx, (const uint4*)va,
      (const uint4*)vb, d, (int64_t)rows);
  return (int)cudaGetLastError();
}

template <int W>
static int gather_launch(const void* a, const void* b, int rows,
                         const void* rows_in, int m, void* x, void* y,
                         void* inf, void* stream) {
  if (m <= 0) return 0;
  gather_rows_kernel<W><<<blocks_for(m * W, 256), 256, 0,
                          (cudaStream_t)stream>>>(
      (const uint4*)a, (const uint4*)b, (const int64_t*)rows_in, (uint4*)x,
      (uint4*)y, (uint8_t*)inf, m, (int64_t)rows);
  return (int)cudaGetLastError();
}

extern "C" int k_scatter_rows_launch(void* ax, void* ay, int rows,
                                     const void* idx, const void* vx,
                                     const void* vy, int d, void* stream) {
  return scatter_launch<3>(ax, ay, rows, idx, vx, vy, d, stream);
}

extern "C" int k_gather_rows_launch(const void* ax, const void* ay, int rows,
                                    const void* rows_in, int m, void* x,
                                    void* y, void* inf, void* stream) {
  return gather_launch<3>(ax, ay, rows, rows_in, m, x, y, inf, stream);
}

extern "C" int k_scatter_sk_rows_launch(void* a, int rows, const void* idx,
                                        const void* v, int d, void* stream) {
  return scatter_launch<2>(a, nullptr, rows, idx, v, nullptr, d, stream);
}

extern "C" int k_gather_sk_rows_launch(const void* a, int rows,
                                       const void* rows_in, int m, void* w,
                                       void* stream) {
  return gather_launch<2>(a, nullptr, rows, rows_in, m, w, nullptr, nullptr,
                          stream);
}
#endif  // __CUDACC__
