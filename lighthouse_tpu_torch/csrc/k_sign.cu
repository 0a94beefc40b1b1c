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
// k_sign_agg: the aggregates of m rows of k wire signatures, in the order
// of the plain version (k_sign_agg_plain: curve.g2_decompress without a
// subgroup check, a masked-off or infinity lane as infinity, the row
// summed by curve.sum_reduce, then g2_compress).  sum_reduce pads a row
// to a power of two with infinity and adds [0::2] to [1::2] a level: it
// pairs (a, a + s) at stride s, a a multiple of 2s.  Off the curve
// addition is not associative, so a row whose ok is False has words that
// depend on that tree; the kernel keeps it.  A segment of 2^t lanes
// aligned at a multiple of 2^t is a subtree, and its sum is a node of the
// tree, so the work splits into blocks: one block a segment of up to
// SA_LANES lanes (sa_prog below) decodes its lanes and sums them, then
// one block a row sums the row's segment sums the same way (more passes
// when a row has more than SA_LANES segments), and the last pass
// compresses.  In a block:
//   decoding, check_coop.cuh's G2 steps with no subgroup check: x to
//     Montgomery form, x^3 + 4(1 + u), its norm and the norm's power by
//     (p - 3) / 4 in one thread a lane (ck_pow on fsqr / fmul, windows of
//     SA_WIN bits), d1^e and s^e in two threads a lane, the root, its
//     check and the wire's sign in one thread: a lane off the curve still
//     enters the sum with the plain version's candidate y, as there;
//   the ok byte: set to 1 on the stream first; a live lane off the curve,
//     or a live infinity with x != 0, writes 0 (the race is benign);
//   the tree: the points sit in bit-reversed order, so the pair (a, a + s)
//     of the tree is slots (j, j + w / 2) at width w, and each level is one
//     complete addition over w / 2 jobs of points_coop.cuh's engine (4
//     product rounds and 1 sum round; a repeated signature by the masked
//     doubling, sigma + (-sigma) infinity);
//   the tail: the norm Z conj(Z), one binary-Euclid inverse in one thread,
//     X / Z^2 and Y / Z^3, then the canonical plain x, the lexicographic
//     sign of y on its real value and the infinity flag.
// Signatures are public: the rounds may branch on them (uniformly over a
// block, on flags read from shared memory after a barrier).  Bound: the
// latency of each lane's two dependent powers (~450 fsqr / fmul each) and
// of the tree's and tail's rounds; the bytes (~100 a lane) are negligible.
// No launch needs a per-thread stack.
//
// k_sign_root in: w (n, 8) uint32 scalar words, msg (n, 8) big-endian words.
// k_sign_field in: w (n, 8), u (n, 2, 2, 12) canonical plain limbs.
// Both out: x (n, 2, 12) canonical plain limbs, sign (n,), inf (n,) uint8.
// k_sign_agg in: x (m, k, 2, 12) canonical plain limbs; sign, inf, mask
// (m, k) uint8; scratch jac (m k, 72 words: the segment sums, Jacobian).
// Out: x (m, 2, 12), sign, inf, ok (m,) uint8.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include "check_coop.cuh"
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

// k_sign_agg's block: a segment of up to SA_LANES lanes (a power of two;
// a row shorter than that takes the next power of two of its length),
// powers with windows of SA_WIN bits, SA_THREADS threads (two a lane: the
// powers d1^e and s^e in one pass), SA_PROD_THREADS of them taking a
// round's products.  SA_LANES, SA_WIN and SA_PROD_THREADS build with -D
// for a comparison (lighthouse_tpu_torch/tools/check_layouts.py).  64
// lanes and 4-bit windows: ~90 KB of shared memory a block, two blocks
// (128 lanes) an SM, so the 32 x 512 aggregate rows run in one wave
// (PERF.md, the k_sign_agg layouts).
#ifndef SA_LANES
#define SA_LANES 64
#endif
#ifndef SA_WIN
#define SA_WIN 4
#endif
constexpr int SA_THREADS = 2 * SA_LANES;
#ifndef SA_PROD_THREADS
#define SA_PROD_THREADS SA_THREADS
#endif

// log2 of the segment of a pass over n points a row (up to S), and the
// segments of a row (host code: the launcher's).
static inline int sa_seg_log2(int n, int S) {
  int t = 0;
  while ((1 << t) < n && (1 << t) < S) t++;
  return t;
}
static inline int sa_segs(int n, int t) {
  return n > 0 ? (n + (1 << t) - 1) >> t : 1;
}

// A block's shared state: the segment's points p[0, S) in bit-reversed
// order and, over the engine's job temporaries (the tree needs them only
// once the lanes are decoded), the lanes' decoding values; dec.p is pc.p
// (the structs' common first member).
template <int S, int W>
union sa_state {
  pc_state<S / 2> pc;
  struct {
    pc_pt p[S];
    ck_dec_t<W> d[S];
  } dec;
};

enum {
  SA_POW1 = PC_PROG, SA_POW2, SA_ROOT, SA_LOAD, SA_NORM, SA_INV, SA_ZI,
  SA_AF1, SA_AF2, SA_OUT
};

// One block: the n lanes (decoding: wire planes x, 24 words a lane, sign,
// inf, mask) or n Jacobian points (jac, 72 words each) of one segment of
// 2^t, summed in the halving tree; out the Jacobian sum at sum (72
// words), or, with sum null (the row's last pass), the compressed planes
// at ox (24 words), osign, oinf.  A decoding block clears *ok for a live
// lane off the curve or a live infinity with x != 0.
template <int S, int W>
struct sa_prog {
  pc_engine<S / 2> e;
  sa_state<S, W>& s;
  bool dec;
  const uint32_t* x;
  const uint8_t *sign, *inf, *mask;
  const uint32_t* jac;
  int n, t;
  uint8_t* ok;
  uint32_t* sum;
  uint32_t* ox;
  uint8_t *osign, *oinf;
  int w;

  LH_MEM int first() {
    e.fb = false;
    return dec ? SA_POW1 : SA_LOAD;
  }

  // The slot of local index i: its t bits reversed.
  LH_MEM int slot(int i) {
    int r = 0;
    for (int b = 0; b < t; b++) r |= ((i >> b) & 1) << (t - 1 - b);
    return r;
  }

  LH_MEM int level() {
    if (w > 1) {
      e.nj = w >> 1;
      e.off = w >> 1;
      return e.start(E_A1);
    }
    if (sum || is_zero(s.pc.p[0].z)) return SA_OUT;
    return SA_NORM;
  }

  LH_MEM int next(int rid) {
    switch (rid) {
      case SA_ROOT: case SA_LOAD:
        w = 1 << t;
        return level();
      case E_D4:                     // only after P == Q
        w >>= 1;
        return level();
      case E_A5:
        if (e.s.dbl_any) {
          e.fb = true;
          return E_D1;
        }
        w >>= 1;
        return level();
      case SA_OUT: return -1;
      default: return rid + 1;       // engine rounds, SA_POW1.., SA_NORM..
    }
  }

  LH_MEM int np(int rid) {
    if (rid < PC_PROG) return e.np(rid);
    switch (rid) {
      case SA_NORM: case SA_ZI: return 1;
      case SA_AF1: case SA_AF2: return 2;
      default: return 0;
    }
  }

  LH_MEM int nl(int rid) {
    if (rid < PC_PROG) return e.nl(rid);
    switch (rid) {
      case SA_POW1: case SA_ROOT: return 1 << t;
      case SA_POW2: return 2 << t;
      case SA_LOAD: return 6 << t;
      case SA_INV: return 1;
      case SA_OUT: return sum ? 6 : 3;
      default: return 0;
    }
  }

  LH_MEM fp2_t* pops(int rid, int k, fp2_t& a, fp2_t& b) {
    if (rid < PC_PROG) return e.pops(rid, k, a, b);
    pc_state<S / 2>& c = s.pc;
    switch (rid) {
      case SA_NORM:                  // N = Z conj(Z), in c0
        a = c.p[0].z;
        conj(b, c.p[0].z);
        return &c.e[E_NRM];
      case SA_ZI:                    // 1/Z = conj(Z) / N
        conj(a, c.p[0].z);
        b = c.e[E_ZI];
        return &c.e[E_ZI];
      default: return pc_affine_ops(c, rid - SA_AF1, k, a, b);
    }
  }

  // SA_POW1: lane k's flags and, for a live finite lane, x and the first
  // power (x in Montgomery form into its slot).
  LH_MEM void pow1(int k) {
    ck_dec_t<W>& d = s.dec.d[k];
    d.inf = k >= n || !mask[k] || inf[k];    // no root to take
    if (k >= n) return;
    fp2_t xw;
    load(xw, x + 24 * (size_t)k);
    if (d.inf) {
      if (mask[k] && !is_zero(xw)) *ok = 0;  // a malformed infinity
      return;
    }
    d.sign = sign[k] != 0;
    ck_dec_pow1(d, s.dec.p[slot(k)].x, xw);
  }

  // SA_ROOT: lane k's point into its slot, infinity where it has none.
  LH_MEM void root(int k) {
    const ck_dec_t<W>& d = s.dec.d[k];
    pc_pt& P = s.dec.p[slot(k)];
    if (d.inf) {
      for (int u = 0; u < 6; u++)
        f2_set_inf_co(co(pt_co(P, u >> 1), u & 1), u >> 1, u & 1);
      return;
    }
    fp2_t y;
    if (!ck_dec_root(y, d)) *ok = 0;         // off the curve: still summed
    P.y = y;
    f2_one(P.z);
  }

  LH_MEM void lin(int rid, int k) {
    if (rid < PC_PROG) {
      e.lin(rid, k);
      return;
    }
    pc_state<S / 2>& c = s.pc;
    switch (rid) {
      case SA_POW1: pow1(k); return;
      case SA_POW2: {
        ck_dec_t<W>& d = s.dec.d[k >> 1];
        if (!d.inf) ck_dec_pow2(d, k & 1);
        return;
      }
      case SA_ROOT: root(k); return;
      case SA_LOAD: {                // point j's coordinate (c, q)
        const int j = k / 6, u = k - 6 * j, cc = u >> 1, q = u & 1;
        fp_t v;
        if (j < n) load(v, jac + 72 * (size_t)j + 24 * cc + 12 * q);
        else f2_set_inf_co(v, cc, q);
        co(pt_co(c.p[slot(j)], cc), q) = v;
        return;
      }
      case SA_INV:
        fp_inv_vt(c.e[E_ZI].c0, c.e[E_NRM].c0);
        set_zero(c.e[E_ZI].c1);
        return;
      default: {                     // SA_OUT
        if (sum) {
          store(sum + 12 * k, co(pt_co(c.p[0], k >> 1), k & 1));
          return;
        }
        const bool in = is_zero(c.p[0].z);
        fp_t one, v, v1;
        set_zero(one);
        one.v[0] = 1;
        if (k < 2) {                 // x, canonical plain
          if (in) set_zero(v);
          else fmul(v, co(c.e[E_AX], k), one);
          store(ox + 12 * k, v);
          return;
        }
        if (in) {
          *osign = 0;
          *oinf = 1;
          return;
        }
        fmul(v, c.e[E_AY].c0, one);  // the sign on the real value of y
        fmul(v1, c.e[E_AY].c1, one);
        *osign = (uint8_t)(is_zero(v1) ? gt_half_p(v) : gt_half_p(v1));
        *oinf = 0;
        return;
      }
    }
  }
};

// Block b of one pass over m rows of n points a row, in segments of 2^t
// (segs a row): dec, the wire planes x, sign, inf, mask; else the points
// at jin.  Out: the segment sums at jout, or with jout null (the last
// pass: one segment a row) the compressed planes ox, osign, oinf.
template <int S, int W>
LH_DEV sa_prog<S, W> sa_block(sa_state<S, W>& s, int b, const uint32_t* x,
                              const uint8_t* sign, const uint8_t* inf,
                              const uint8_t* mask, const uint32_t* jin,
                              int dec, int n, int t, int segs,
                              uint32_t* jout, uint32_t* ox, uint8_t* osign,
                              uint8_t* oinf, uint8_t* ok) {
  const int row = b / segs, g = b - row * segs;
  const int l0 = g << t, left = n - l0;
  const size_t at = (size_t)row * n + l0;
  const bool fin = jout == nullptr;
  return sa_prog<S, W>{
      {s.pc, 0, 0, false}, s, dec != 0,
      dec ? x + 24 * at : nullptr, dec ? sign + at : nullptr,
      dec ? inf + at : nullptr, dec ? mask + at : nullptr,
      dec ? nullptr : jin + 72 * at, left < (1 << t) ? left : 1 << t, t,
      ok + row, fin ? nullptr : jout + 72 * ((size_t)row * segs + g),
      fin ? ox + 24 * row : nullptr, fin ? osign + row : nullptr,
      fin ? oinf + row : nullptr, 0};
}

// The passes of k_sign_agg over m rows of k lanes, segments of up to S, at
// most max_passes of them: pass(dec, n, t, segs, jin, jout) runs one (jout
// null: the last).  A pass's segment sums go to the scratch jac after the
// pass before's (at most m k points in all).  Returns pass's first nonzero
// result.
template <int S, class PASS>
static int sa_passes(int m, int k, uint32_t* jac, int max_passes,
                     PASS pass) {
  const uint32_t* jin = nullptr;
  uint32_t* jbuf = jac;
  int n = k, dec = 1;
  for (int p = 0; p < max_passes; p++) {
    const int t = sa_seg_log2(n, S), segs = sa_segs(n, t);
    const bool fin = segs == 1;
    const int e = pass(dec, n, t, segs, jin, fin ? nullptr : jbuf);
    if (e || fin) return e;
    jin = jbuf;
    jbuf += 72 * (size_t)m * segs;
    n = segs;
    dec = 0;
  }
  return 0;
}
static_assert(SA_LANES >= 4 && (SA_LANES & (SA_LANES - 1)) == 0,
              "a segment is a power of two, and the scratch holds the "
              "passes' sums from 4 lanes up");

#ifdef __CUDACC__
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

extern __shared__ __align__(16) unsigned char sa_smem[];

// One pass of k_sign_agg: a block a segment of 2^t of a row's n points
// (segs a row); dec: the wire planes, else n Jacobian points a row at jin;
// out the segment sums at jout (72 words), or with jout null (one segment
// a row) the compressed planes.
__global__ void __launch_bounds__(SA_THREADS, 1) k_sign_agg_kernel(
    const uint32_t* __restrict__ x, const uint8_t* __restrict__ sign,
    const uint8_t* __restrict__ inf, const uint8_t* __restrict__ mask,
    const uint32_t* __restrict__ jin, int dec, int n, int t, int segs,
    uint32_t* __restrict__ jout, uint32_t* __restrict__ ox,
    uint8_t* __restrict__ osign, uint8_t* __restrict__ oinf,
    uint8_t* __restrict__ ok) {
  auto& s = *reinterpret_cast<sa_state<SA_LANES, SA_WIN>*>(sa_smem);
  lh_block<SA_PROD_THREADS, SA_THREADS, lh_ptx> grp{(int)threadIdx.x};
  auto pr = sa_block(s, blockIdx.x, x, sign, inf, mask, jin, dec, n, t, segs,
                     jout, ox, osign, oinf, ok);
  lh_run(grp, pr);
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

// The passes of k_sign_agg, at most max_passes of them (the layout tool
// times the first alone).
static int sign_agg(const void* xin, const void* sin, const void* iin,
                    const void* mask, int m, int k, void* jac, void* x,
                    void* sign, void* inf, void* ok, int max_passes,
                    cudaStream_t st) {
  if (m <= 0) return 0;
  const size_t smem = sizeof(sa_state<SA_LANES, SA_WIN>);
  cudaError_t e = cudaFuncSetAttribute(
      k_sign_agg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(ok, 1, (size_t)m, st);   // AND over no lane is true
  if (e != cudaSuccess) return (int)e;
  return sa_passes<SA_LANES>(
      m, k, (uint32_t*)jac, max_passes,
      [&](int dec, int n, int t, int segs, const uint32_t* jin,
          uint32_t* jout) {
        k_sign_agg_kernel<<<m * segs, SA_THREADS, smem, st>>>(
            (const uint32_t*)xin, (const uint8_t*)sin, (const uint8_t*)iin,
            (const uint8_t*)mask, jin, dec, n, t, segs, jout, (uint32_t*)x,
            (uint8_t*)sign, (uint8_t*)inf, (uint8_t*)ok);
        return (int)cudaGetLastError();
      });
}

extern "C" int k_sign_agg_launch(const void* xin, const void* sin,
                                 const void* iin, const void* mask, int m,
                                 int k, void* jac, void* x, void* sign,
                                 void* inf, void* ok, void* stream) {
  return sign_agg(xin, sin, iin, mask, m, k, jac, x, sign, inf, ok, 1 << 30,
                  (cudaStream_t)stream);
}

// The first pass alone (the decoding and the segment sums), the same
// arguments: for a comparison of the passes' times.
extern "C" int k_sign_agg_first_pass_launch(const void* xin, const void* sin,
                                            const void* iin, const void* mask,
                                            int m, int k, void* jac, void* x,
                                            void* sign, void* inf, void* ok,
                                            void* stream) {
  return sign_agg(xin, sin, iin, mask, m, k, jac, x, sign, inf, ok, 1,
                  (cudaStream_t)stream);
}

// Blocks of k_sign_agg_kernel an SM holds at once (out: a host pointer to
// one int).
extern "C" int k_sign_agg_occupancy(int* out) {
  const size_t smem = sizeof(sa_state<SA_LANES, SA_WIN>);
  cudaError_t e = cudaFuncSetAttribute(
      k_sign_agg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, k_sign_agg_kernel, SA_THREADS, smem);
}
#endif  // __CUDACC__
