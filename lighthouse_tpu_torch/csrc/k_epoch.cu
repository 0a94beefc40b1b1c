// The epoch engine's two kernels: the registry-wide passes of an
// altair-family epoch transition over a struct-of-arrays snapshot.
//
// Replaces the JAX kernels of
// lighthouse_tpu/state_transition/epoch_engine/kernels.py:
//   k_sums   :90   the six balance reductions -> uint64[6]: total active
//                  balance, the three previous-epoch flag balances
//                  (unslashed, participating), the current target balance,
//                  the active count
//   k_state  :118  the fused per-validator update -> new inactivity
//                  scores, balances and effective balances
//
// Layout: the uint64 planes travel as int64 tensors holding the uint64 bit
// patterns, `slashed` and the participation flags as uint8 (non-zero is
// set).  The card computes in native uint64_t, wraparound included, which
// is the JAX kernels' arithmetic; there is no lane padding (the TPU kernels
// pad to a power-of-two bucket), any n is taken.
//
// k_sums: one thread a validator, grid-stride over at most 8 blocks an SM;
// the six partial sums go up through a warp shuffle and a shared-memory
// block reduction, then one atomicAdd a sum a block into the 6-word output,
// which the C entry zeroes on the stream first.  Integer sums are exact in
// any order, so the result is the same whatever order the atomics land in.
// Bound: bytes (27 a lane: three uint64 planes and three uint8 planes).
//
// k_state: one thread a validator.  The 18 epoch scalars go by value, as a
// struct kernel parameter (144 bytes), copied from a host array by the C
// entry.  Bound: bytes (50 read and 24 written a lane) or, likelier, the
// 64-bit divisions by runtime divisors (eff / incr, the three reward
// quotients, the inactivity penalty, the slashing quotient, b % incr),
// each a software routine on this card; the kernel divides only where the
// lane uses the quotient.  Reciprocal multiplication for the
// epoch-constant divisors is left for later.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

// Packed scalar layout (kernels.py:47-52).
enum {
  S_PREV, S_CUR, S_LEAK, S_PER_INCR, S_TOTAL_INCR, S_PART0, S_PART1,
  S_PART2, S_BIAS, S_RECOVERY, S_INACT_DENOM, S_ADJUSTED, S_TOTAL_ACTIVE,
  S_INCR, S_MAX_EFF, S_DOWN, S_UP, S_SLASH_WD, N_SCALARS
};

struct EpochScalars {
  uint64_t s[N_SCALARS];
};

#define LH_EPOCH_THREADS 256

__device__ __forceinline__ uint64_t umin64(uint64_t a, uint64_t b) {
  return a < b ? a : b;
}

__global__ void __launch_bounds__(LH_EPOCH_THREADS)
k_sums_kernel(const uint64_t* __restrict__ eff,
              const uint64_t* __restrict__ act,
              const uint64_t* __restrict__ exitp,
              const uint8_t* __restrict__ slashed,
              const uint8_t* __restrict__ pflags,
              const uint8_t* __restrict__ cflags, uint64_t prev,
              uint64_t cur, unsigned long long* __restrict__ out, int n) {
  unsigned long long acc[6] = {0, 0, 0, 0, 0, 0};
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const uint64_t e = eff[i], a = act[i], x = exitp[i];
    const bool active_cur = a <= cur && cur < x;
    const bool active_prev = a <= prev && prev < x;
    const bool unslashed = slashed[i] == 0;
    const unsigned pf = pflags[i];
    if (active_cur) {
      acc[0] += e;
      acc[5] += 1;
    }
    if (active_prev && unslashed) {
      if (pf & 1) acc[1] += e;
      if (pf & 2) acc[2] += e;
      if (pf & 4) acc[3] += e;
    }
    if (active_cur && unslashed && (cflags[i] & 2)) acc[4] += e;
  }
#pragma unroll
  for (int k = 0; k < 6; k++) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
  }
  __shared__ unsigned long long part[6][LH_EPOCH_THREADS / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 6; k++) part[k][warp] = acc[k];
  }
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x / 32;
#pragma unroll
    for (int k = 0; k < 6; k++) {
      unsigned long long v = lane < warps ? part[k][lane] : 0ull;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0 && v) atomicAdd(out + k, v);
    }
  }
}

__global__ void __launch_bounds__(LH_EPOCH_THREADS)
k_state_kernel(const uint64_t* __restrict__ eff,
               const uint64_t* __restrict__ bal,
               const uint8_t* __restrict__ slashed,
               const uint64_t* __restrict__ act,
               const uint64_t* __restrict__ exitp,
               const uint64_t* __restrict__ wd,
               const uint64_t* __restrict__ scores,
               const uint8_t* __restrict__ pflags, const EpochScalars sc,
               uint64_t* __restrict__ out_scores,
               uint64_t* __restrict__ out_bal,
               uint64_t* __restrict__ out_eff, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint64_t* s = sc.s;
  const uint64_t prev = s[S_PREV];
  const bool leak = s[S_LEAK] != 0;
  const uint64_t incr = s[S_INCR];
  const uint64_t e = eff[i], a = act[i], x = exitp[i], w = wd[i];
  const bool is_slashed = slashed[i] != 0;
  const unsigned pf = pflags[i];

  const bool active_prev = a <= prev && prev < x;
  const bool eligible = active_prev || (is_slashed && prev + 1 < w);
  const bool unslashed = !is_slashed;
  const bool in_target = (pf & 2) && active_prev && unslashed;

  // Inactivity scores (process_inactivity_updates).
  uint64_t sc_new = scores[i];
  if (eligible) {
    if (in_target)
      sc_new -= umin64(1, sc_new);
    else
      sc_new += s[S_BIAS];
    if (!leak) sc_new -= umin64(s[S_RECOVERY], sc_new);
  }
  out_scores[i] = sc_new;

  // Rewards and penalties (process_rewards_and_penalties_altair).
  uint64_t rewards = 0, penalties = 0;
  if (eligible) {
    const uint64_t base = (e / incr) * s[S_PER_INCR];
    const uint64_t reward_div = s[S_TOTAL_INCR] * 64;
    const uint64_t weights[3] = {14, 26, 14};
#pragma unroll
    for (int f = 0; f < 3; f++) {
      const bool participating = ((pf >> f) & 1) && active_prev && unslashed;
      if (participating) {
        if (!leak)
          rewards += base * weights[f] * s[S_PART0 + f] / reward_div;
      } else if (f != 2) {  // TIMELY_HEAD carries no miss penalty
        penalties += base * weights[f] / 64;
      }
    }
    if (!in_target) penalties += e * sc_new / s[S_INACT_DENOM];
  }
  uint64_t b = bal[i] + rewards;
  b -= umin64(b, penalties);

  // Slashings sweep (process_slashings), against the post-registry
  // withdrawable epochs.
  if (is_slashed && w == s[S_SLASH_WD]) {
    const uint64_t pen =
        (e / incr) * s[S_ADJUSTED] / s[S_TOTAL_ACTIVE] * incr;
    b -= umin64(b, pen);
  }
  out_bal[i] = b;

  // Effective-balance hysteresis (process_effective_balance_updates).
  const bool update = b + s[S_DOWN] < e || e + s[S_UP] < b;
  out_eff[i] = update ? umin64(b - b % incr, s[S_MAX_EFF]) : e;
}

static int grid_for(int n) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int blocks = (n + LH_EPOCH_THREADS - 1) / LH_EPOCH_THREADS;
  return blocks < 8 * sms ? blocks : 8 * sms;
}

// eff, act, exitp (n) uint64; slashed, pflags, cflags (n) uint8;
// scal_host: a HOST array {prev, cur}; out (6) uint64, zeroed here.
extern "C" int k_sums_launch(const void* eff, const void* act,
                             const void* exitp, const void* slashed,
                             const void* pflags, const void* cflags,
                             const void* scal_host, void* out, int n,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(out, 0, 6 * sizeof(uint64_t), st);
  if (n > 0) {
    const uint64_t* sc = (const uint64_t*)scal_host;
    k_sums_kernel<<<grid_for(n), LH_EPOCH_THREADS, 0, st>>>(
        (const uint64_t*)eff, (const uint64_t*)act, (const uint64_t*)exitp,
        (const uint8_t*)slashed, (const uint8_t*)pflags,
        (const uint8_t*)cflags, sc[0], sc[1], (unsigned long long*)out, n);
  }
  return (int)cudaGetLastError();
}

// eff, bal, act, exitp, wd, scores (n) uint64; slashed, pflags (n) uint8;
// scal_host: a HOST array of the N_SCALARS epoch scalars; out_* (n) uint64.
extern "C" int k_state_launch(const void* eff, const void* bal,
                              const void* slashed, const void* act,
                              const void* exitp, const void* wd,
                              const void* scores, const void* pflags,
                              const void* scal_host, void* out_scores,
                              void* out_bal, void* out_eff, int n,
                              void* stream) {
  if (n <= 0) return 0;
  EpochScalars sc;
  memcpy(sc.s, scal_host, sizeof(sc.s));
  const int blocks = (n + LH_EPOCH_THREADS - 1) / LH_EPOCH_THREADS;
  k_state_kernel<<<blocks, LH_EPOCH_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)eff, (const uint64_t*)bal, (const uint8_t*)slashed,
      (const uint64_t*)act, (const uint64_t*)exitp, (const uint64_t*)wd,
      (const uint64_t*)scores, (const uint8_t*)pflags, sc,
      (uint64_t*)out_scores, (uint64_t*)out_bal, (uint64_t*)out_eff, n);
  return (int)cudaGetLastError();
}
