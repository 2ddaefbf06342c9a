// Hand-written Hopper (sm_90a) kernels for the fp64-class ELL gather: the
// CUDA counterparts of two Pallas TPU kernels in
// fastsparse/ops/pallas/ell_spmm.py, on one pair of kernels templated on
// the value form.
//
//   fs_ell_dd, valued = 0  <- ell_bucket_spmm_dd (#12, body _body_unit_dd)
//       unit values: (hi, lo)[r] = TwoSum chain of x[col[r,k]] over k
//   fs_ell_dd, valued = 1  <- ell_bucket_spmm_dd_valued (#13, _body_dd_valued)
//       (hi, lo)[r] = Σ_k (vh + vl)[r,k] · (xh + xl)[col[r,k]] in double-word
//       f32: a Dekker TwoProd of vh·xh, the cross terms vh·xl + vl·xh, and
//       a TwoSum into (hi, lo)
//
// The f64 operand X arrives as one f32 panel x2 of 2·k_rows rows: its hi
// plane in rows [0, k_rows), its lo plane in rows [k_rows, 2·k_rows), so a
// column c reads rows c and k_rows + c. Unit buckets pad with the sentinel
// column (a zero row of both planes); valued buckets pad with column 0 and
// zero values. Each launcher takes raw device pointers, sizes and a
// cudaStream_t, runs on that stream, allocates nothing and returns
// cudaGetLastError().
//
// Arithmetic: the reference's, operation for operation and in the same
// nesting, in strict f32. Every step is an explicit round-to-nearest
// intrinsic (__fadd_rn, __fsub_rn, __fmul_rn), which nvcc never contracts
// into an FMA or reassociates, and the library is built with --fmad=false
// as well. An FMA would break TwoSum and Dekker's split: the low words
// would come out other than the reference's. The TwoProd keeps Dekker's
// 4097 split rather than an FMA residual for the same reason. H100 has
// native f64, but these kernels compute the double-word arithmetic of the
// TPU kernels so that the two can be held bit for bit.
//
// Design. The TPU kernel carries (hi, lo) across an in-order
// ("arbitrary") grid axis over the row's K slots. Only hi and lo carry
// from one slot to the next: a slot's terms depend on that slot's inputs
// alone. Unit values: the terms are the gathered (xh, xl); valued: the
// Dekker splits, p1 = vh·xh and q = perr + cross (dd_terms).
//
// What bounds both forms on this card is the chain, not the bytes. One
// thread a chain walking a long row pays, per slot, an index load, then a
// dependent gather, then the chain's adds: #13 took 0.25 ms for config
// 2-fp64's 8 rows of 2,048 slots, #12 0.15 ms for config B's 16 such
// rows at N=32, while the card idled. So one pair of kernels, templated
// on the value form (DdForm: the staged arrays and the constants that
// differ between the forms), chosen by one launcher (launch_dd):
// - ell_dd_split_kernel (few rows, or long ones): a block owns R rows
//   and TPR lanes and walks K in slices. The slice's staged arrays (cols,
//   and vh, vl when valued) for its rows are copied into shared memory by
//   cp.async (16, 8 or 4 bytes, coalesced along each row), the next slice
//   in flight while this one is used. Every thread computes the terms of
//   many (row, slot, lane) items at once, all gathers of a batch sent
//   before use, into a contiguous row of shared memory per (row, lane).
//   Then thread (row, lane) runs the exact chain over them, its reads
//   DD_AHEAD slots ahead: per slot one shared-memory read and the TwoSum's
//   eight adds, of which only s = hi + a and lo + (e + b) carry. R is
//   halved from 256 / TPR while the grid holds fewer than two blocks an
//   SM and a block has more than DD_THREADS·kBatch items a slice, so a
//   bucket of a few long rows runs a block a row.
// - ell_dd_rows_kernel (many rows, or rows of at most DD_SHORT_K slots):
//   one thread per (row, lane), each step's indices (and value planes)
//   and X gathers, kStep slots of them, loaded before its terms and
//   chain steps.
// Config B's unit buckets at N=32 run the rows kernel from 528 rows up
// (its 18,864 x 32 bucket, say: there the L2 read rate bounds it, and
// loading further ahead only slowed it) and the split kernel below,
// 8 lanes a block (its rows of 48 to 2,048 slots); config 2-fp64's (N=1)
// the split kernel on every bucket but those of at most 8 slots. The
// operations and their nesting are the reference's (_body_unit_dd,
// _body_dd_valued) in both kernels, so the outputs are bit-equal
// whichever runs. A lone thread's chain step takes ~16-18 cycles in
// either form (PERF.md): the chain, not the bytes, sets the time of a
// 2,048-slot row.
//
// Bound on this card: bytes, by the bound's rule. #12 reads 4 B of index
// per slot, #13 12 B (index, vh, vl), plus each gathered X row in both
// planes and each output written once (hi and lo). #12 does 8 f32
// operations per slot and lane, #13 25 (plus 4 per slot for the split of
// vh); against 67 TFLOP/s that is below the time of the bytes at 3.35
// TB/s at the main path's shapes. The gathered rows are scattered, so
// they come through L2: at N=32 each slot reads 256 B of X there.

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int DD_THREADS = 256;
// dynamic shared memory per block of the split kernel (no opt-in needed);
// the slots the split kernel's chain reads ahead of its adds; the longest
// rows that go to the rows kernel whatever the grid
constexpr int DD_SMEM_BYTES = 48 * 1024;
constexpr int DD_AHEAD = 8;
constexpr int DD_SHORT_K = 8;

// Each value form's constants (template parameters, not runtime flags):
// kArrays, the arrays staged per slot (cols, and vh, vl when valued);
// kBatch, the items a thread's term pass takes at once; kStep, the slots
// a rows-kernel step loads before its chain steps; kRowsBlocksPerSm, the
// least grid, in blocks an SM, that goes to the rows kernel;
// kSplitLanesLog2, log2 of the most lanes a split block takes.
template <bool VALUED>
struct DdForm {
  static constexpr int kArrays = 3;
  static constexpr int kBatch = 4;
  static constexpr int kStep = 8;
  static constexpr float kRowsBlocksPerSm = 2.0f;
  static constexpr int kSplitLanesLog2 = 5;
};
// Unit (measured, PERF.md): a term is a gather and a copy, so more of them
// in flight; a rows-kernel step of one slot (steps of 8 slowed config B's
// many-row buckets, held by the L2 read rate, 0.021 -> 0.027 ms), and
// that kernel from half a block an SM; split blocks of 8 lanes, so that a
// few long rows at N=32 spread their term passes over 4x the SMs.
template <>
struct DdForm<false> {
  static constexpr int kArrays = 1;
  static constexpr int kBatch = 16;
  static constexpr int kStep = 1;
  static constexpr float kRowsBlocksPerSm = 0.5f;
  static constexpr int kSplitLanesLog2 = 3;
};

// Dekker split at 4097 (12/12 bits): hi + lo == a exactly
__device__ __forceinline__ void split4097(float a, float& hi, float& lo) {
  const float c = __fmul_rn(a, 4097.0f);
  hi = __fsub_rn(c, __fsub_rn(c, a));
  lo = __fsub_rn(a, hi);
}

// One slot's step of a row's (hi, lo) chain: branch-free TwoSum(hi, a)
// and its residue plus b into the low word. Unit values: (a, b) = (xh,
// xl); valued: (a, b) = dd_terms(...).
__device__ __forceinline__ void dd_chain(float& hi, float& lo, float a,
                                         float b) {
  const float s = __fadd_rn(hi, a);
  const float bb = __fsub_rn(s, hi);
  const float e = __fadd_rn(__fsub_rn(hi, __fsub_rn(s, bb)), __fsub_rn(a, bb));
  hi = s;
  lo = __fadd_rn(lo, __fadd_rn(e, b));
}

// A chain over the terms t[0 .. n) in slot order, its reads DD_AHEAD
// slots ahead of its steps (the chain waits on its adds, not on its
// reads); t must be readable up to t[n + DD_AHEAD - 1].
__device__ __forceinline__ void chain_walk(const float2* t, int n, float& hi,
                                           float& lo) {
  const int nfull = n - n % DD_AHEAD;
  float2 cur[DD_AHEAD];
#pragma unroll
  for (int u = 0; u < DD_AHEAD; ++u) cur[u] = t[u];
  for (int k = 0; k < nfull; k += DD_AHEAD) {
    float2 nxt[DD_AHEAD];
#pragma unroll
    for (int u = 0; u < DD_AHEAD; ++u) nxt[u] = t[k + DD_AHEAD + u];
#pragma unroll
    for (int u = 0; u < DD_AHEAD; ++u) dd_chain(hi, lo, cur[u].x, cur[u].y);
#pragma unroll
    for (int u = 0; u < DD_AHEAD; ++u) cur[u] = nxt[u];
  }
#pragma unroll
  for (int u = 0; u < DD_AHEAD; ++u) {
    if (nfull + u < n) dd_chain(hi, lo, cur[u].x, cur[u].y);
  }
}

// A valued slot's terms, which depend on the slot's inputs alone: (p1, q)
// with p1 = vh·xh and q = perr + cross, Dekker's TwoProd residue of vh·xh
// and the cross terms vh·xl + vl·xh, in the reference's order.
__device__ __forceinline__ float2 dd_terms(float v_h, float v_l, float xh,
                                           float xl) {
  float vhh, vhl, xhh, xhl;
  split4097(v_h, vhh, vhl);
  split4097(xh, xhh, xhl);
  const float p1 = __fmul_rn(v_h, xh);
  // vhl·xhl + (vhl·xhh + (vhh·xhl + (vhh·xhh − p1)))
  const float perr = __fadd_rn(
      __fmul_rn(vhl, xhl),
      __fadd_rn(__fmul_rn(vhl, xhh),
                __fadd_rn(__fmul_rn(vhh, xhl),
                          __fsub_rn(__fmul_rn(vhh, xhh), p1))));
  const float cross = __fadd_rn(__fmul_rn(v_h, xl), __fmul_rn(v_l, xh));
  return make_float2(p1, __fadd_rn(perr, cross));
}

// A slot's chain terms: the gathered (xh, xl) for unit values (a padding
// slot reads the sentinel's zeros), dd_terms(...) for valued ones.
template <bool VALUED>
__device__ __forceinline__ float2 slot_terms(float v_h, float v_l, float xh,
                                             float xl) {
  if constexpr (VALUED) {
    return dd_terms(v_h, v_l, xh, xl);
  } else {
    return make_float2(xh, xl);
  }
}

// The rows kernel (every thread a chain): one thread per (bucket row,
// lane) walks the row's slots STEP at a time: the step's indices (and
// value planes), then all of its X gathers, then its terms and chain
// steps in slot order. vh, vl unused when unit.
template <bool VALUED>
__global__ void __launch_bounds__(DD_THREADS)
ell_dd_rows_kernel(const int32_t* __restrict__ cols,
                   const float* __restrict__ vh, const float* __restrict__ vl,
                   const float* __restrict__ x2, float* __restrict__ out_hi,
                   float* __restrict__ out_lo, int nb, int K, int k_rows,
                   int ldx, int tpr_log2) {
  constexpr int STEP = DdForm<VALUED>::kStep;
  const int tpr = 1 << tpr_log2;
  const int r = blockIdx.x * (DD_THREADS >> tpr_log2) + (threadIdx.x >> tpr_log2);
  const int lane = blockIdx.y * tpr + (threadIdx.x & (tpr - 1));
  if (r >= nb || lane >= ldx) return;
  const size_t row0 = (size_t)r * K;
  const size_t lo_plane = (size_t)k_rows * ldx;
  float hi = 0.0f, lo = 0.0f;
  for (int k0 = 0; k0 < K; k0 += STEP) {
    int c[STEP];
    float a[STEP], b[STEP], xh[STEP], xl[STEP];
#pragma unroll
    for (int u = 0; u < STEP; ++u) {
      const bool ok = k0 + u < K;
      c[u] = ok ? __ldg(cols + row0 + k0 + u) : 0;
      if constexpr (VALUED) {
        a[u] = ok ? __ldg(vh + row0 + k0 + u) : 0.0f;
        b[u] = ok ? __ldg(vl + row0 + k0 + u) : 0.0f;
      } else {
        a[u] = b[u] = 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < STEP; ++u) {
      const size_t xo = (size_t)c[u] * ldx + lane;
      const bool ok = k0 + u < K;
      xh[u] = ok ? __ldg(x2 + xo) : 0.0f;
      xl[u] = ok ? __ldg(x2 + lo_plane + xo) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < STEP; ++u) {
      if (k0 + u < K) {
        const float2 pq = slot_terms<VALUED>(a[u], b[u], xh[u], xl[u]);
        dd_chain(hi, lo, pq.x, pq.y);
      }
    }
  }
  out_hi[(size_t)r * ldx + lane] = hi;
  out_lo[(size_t)r * ldx + lane] = lo;
}

// The split kernel (few rows, or long ones): a block owns R = 2^r_log2
// bucket rows and TPR = 2^tpr_log2 lanes, R·TPR <= DD_THREADS, and walks
// K in slices of ks slots. Per slice: the rows' staged arrays (cols, and
// vh, vl when valued) are copied into shared memory (cp.async of CPB
// bytes, the next slice in flight while this one is used); every thread
// computes the terms of (row, slot, lane) items, lane fastest, BATCH at a
// time with their gathers sent first, into one row of rs >= ks float2
// per chain (rs odd: the chains' reads at one slot hit different banks; a
// chain's slots are contiguous, so its reads need no address arithmetic);
// then thread (row, lane) runs its chain over the slice in slot order,
// its reads STEP slots ahead of its adds.
template <bool VALUED, int CPB>
__global__ void __launch_bounds__(DD_THREADS)
ell_dd_split_kernel(const int32_t* __restrict__ cols,
                    const float* __restrict__ vh, const float* __restrict__ vl,
                    const float* __restrict__ x2, float* __restrict__ out_hi,
                    float* __restrict__ out_lo, int nb, int K, int k_rows,
                    int ldx, int tpr_log2, int r_log2, int ks) {
  using F = DdForm<VALUED>;
  constexpr int NA = F::kArrays;
  constexpr int BATCH = F::kBatch;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tpr = 1 << tpr_log2;
  const int nst = K > ks ? 2 : 1;
  const int sw = (1 << r_log2) * ks;  // staged words per array
  const int rs = ks | 1;              // terms per chain
  int32_t* s_in = reinterpret_cast<int32_t*>(smem_raw);  // [nst][NA][sw]
  float2* terms = reinterpret_cast<float2*>(
      smem_raw + (((size_t)nst * NA * sw * 4 + 15) & ~(size_t)15));
  const int row0 = blockIdx.x << r_log2;
  const int nrows = min(1 << r_log2, nb - row0);
  const int lane0 = blockIdx.y * tpr;
  const size_t lo_plane = (size_t)k_rows * ldx;
  const int cr = threadIdx.x >> tpr_log2;  // this thread's chain
  const int cl = threadIdx.x & (tpr - 1);
  const bool chain = cr < nrows && lane0 + cl < ldx;
  const bool lane_ok = lane0 + cl < ldx;
  // the term pass: thread t takes lane t % TPR of (row, slot) pairs
  // t / TPR, t / TPR + P, ..., P = DD_THREADS / TPR pairs a pass
  const int P = DD_THREADS >> tpr_log2;
  float hi = 0.0f, lo = 0.0f;

  // the rows' slots [k0, k0 + kw) into stage st
  auto stage = [&](int st, int k0, int kw) {
    int32_t* d = s_in + st * NA * sw;
    constexpr int E = CPB / 4;
    const int per_row = kw / E;
    for (int i = threadIdx.x; i < nrows * per_row; i += DD_THREADS) {
      const int rr = i / per_row;
      const int c = (i - rr * per_row) * E;
      const size_t g = (size_t)(row0 + rr) * K + k0 + c;
      const int o = rr * ks + c;
      acp::cp_async<CPB>(d + o, cols + g);
      if constexpr (VALUED) {
        acp::cp_async<CPB>(d + sw + o, vh + g);
        acp::cp_async<CPB>(d + 2 * sw + o, vl + g);
      }
    }
    acp::cp_async_commit();
  };

  if (K > 0) stage(0, 0, min(ks, K));
  for (int sl = 0, k0 = 0; k0 < K; ++sl, k0 += ks) {
    const int kw = min(ks, K - k0);
    const int st = sl & (nst - 1);
    const bool more = k0 + ks < K;
    // the other stage was consumed before the last slice's final barrier
    if (more) stage(st ^ 1, k0 + ks, min(ks, K - k0 - ks));
    if (more) {
      acp::cp_async_wait<1>();
    } else {
      acp::cp_async_wait<0>();
    }
    __syncthreads();
    const int32_t* s_col = s_in + st * NA * sw;
    const float* s_vh = reinterpret_cast<const float*>(s_col + sw);
    const float* s_vl = reinterpret_cast<const float*>(s_col + 2 * sw);
    // pair p's (row, slot) advance by P pairs without a division
    const int npairs = nrows * kw;
    const int dr = P / kw, dk = P - (P / kw) * kw;
    const int p0 = threadIdx.x >> tpr_log2;
    // the slice's terms, BATCH items a thread at a time
    for (int p = p0, rr = p0 / kw, k = p0 - (p0 / kw) * kw; p < npairs;) {
      float xh[BATCH], xl[BATCH], a[BATCH], b[BATCH];
      int at[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const bool ok = p < npairs && lane_ok;
        const int si = rr * ks + k;
        at[u] = ok ? ((rr << tpr_log2) + cl) * rs + k : -1;
        const int c = ok ? s_col[si] : 0;
        if constexpr (VALUED) {
          a[u] = ok ? s_vh[si] : 0.0f;
          b[u] = ok ? s_vl[si] : 0.0f;
        } else {
          a[u] = b[u] = 0.0f;
        }
        const size_t xo = (size_t)c * ldx + lane0 + cl;
        xh[u] = ok ? __ldg(x2 + xo) : 0.0f;
        xl[u] = ok ? __ldg(x2 + lo_plane + xo) : 0.0f;
        p += P;
        rr += dr;
        k += dk;
        if (k >= kw) {
          k -= kw;
          ++rr;
        }
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        if (at[u] >= 0) {
          terms[at[u]] = slot_terms<VALUED>(a[u], b[u], xh[u], xl[u]);
        }
      }
    }
    __syncthreads();
    // the slice's chain, one thread per (row, lane)
    if (chain) chain_walk(terms + threadIdx.x * rs, kw, hi, lo);
    __syncthreads();  // terms and stage st are free
  }
  if (chain) {
    const size_t o = (size_t)(row0 + cr) * ldx + lane0 + cl;
    out_hi[o] = hi;
    out_lo[o] = lo;
  }
}

int sm_count() {
  static int n = 0;
  if (n <= 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0) {
      n = 132;
    }
  }
  return n;
}

// One bucket's launch, for either value form. Every thread a chain (the
// rows kernel, 256 / TPR rows a block) when that grid holds
// kRowsBlocksPerSm blocks an SM (two valued, half a block unit), or the
// rows are at most DD_SHORT_K slots. Else the split kernel, at most
// 2^kSplitLanesLog2 lanes a block (more lane blocks when X is wider), R
// halved from 256 / TPR while the grid holds fewer than two blocks an SM
// and a block has more than DD_THREADS·kBatch items a slice (a bucket of
// a few long rows runs a block a row and lane block). Its copy:
// 16-byte cp.async where the rows and the staged buffers allow it, else 8
// or 4. Its slice: all of K when the staged arrays, terms and read-ahead
// fit DD_SMEM_BYTES, else the fewest equal slices that fit, each a
// multiple of the copy's entries.
template <bool VALUED>
int launch_dd(const int32_t* cols, const float* vh, const float* vl,
              const float* x2, float* out_hi, float* out_lo, int nb, int K,
              int k_rows, int ldx, int tpr_log2, int n_lane_blocks,
              cudaStream_t st) {
  using F = DdForm<VALUED>;
  auto blocks = [&](int r_log2) {
    return (long long)((nb + (1 << r_log2) - 1) >> r_log2) * n_lane_blocks;
  };
  int r_log2 = 8 - tpr_log2;
  if (K <= DD_SHORT_K ||
      (double)blocks(r_log2) >= (double)F::kRowsBlocksPerSm * sm_count()) {
    dim3 grid((unsigned)blocks(r_log2) / n_lane_blocks, n_lane_blocks);
    ell_dd_rows_kernel<VALUED><<<grid, DD_THREADS, 0, st>>>(
        cols, vh, vl, x2, out_hi, out_lo, nb, K, k_rows, ldx, tpr_log2);
    return 0;
  }
  if (tpr_log2 > F::kSplitLanesLog2) {
    tpr_log2 = F::kSplitLanesLog2;
    n_lane_blocks = (ldx + (1 << tpr_log2) - 1) >> tpr_log2;
    if (n_lane_blocks > 65535) return (int)cudaErrorInvalidValue;
    r_log2 = 8 - tpr_log2;
  }
  while (r_log2 > 0 && blocks(r_log2) < 2LL * sm_count() &&
         ((long long)K << (r_log2 + tpr_log2)) > DD_THREADS * F::kBatch) {
    --r_log2;
  }
  const int R = 1 << r_log2, tpr = 1 << tpr_log2;
  auto aligned = [&](int b) {
    return (K * 4) % b == 0 && (uintptr_t)cols % b == 0 &&
           (!VALUED || ((uintptr_t)vh % b == 0 && (uintptr_t)vl % b == 0));
  };
  const int cpb = aligned(16) ? 16 : aligned(8) ? 8 : 4;
  const int E = cpb / 4;
  // staged arrays, then the terms of each slot of each chain, and the
  // chain's read-ahead past the last
  auto smem_of = [&](int ks, int nst) {
    return (((size_t)nst * F::kArrays * R * ks * 4 + 15) & ~(size_t)15) +
           ((size_t)R * tpr * (ks | 1) + DD_AHEAD) * 8;
  };
  int ks = K;
  if (smem_of(K, 1) > (size_t)DD_SMEM_BYTES) {
    // per slot and row: two stages of kArrays words, TPR terms
    const int ks_max =
        ((DD_SMEM_BYTES - 16 - DD_AHEAD * 8) / R - 8 * tpr) /
        (8 * F::kArrays + 8 * tpr) / E * E;
    if (ks_max <= 0) return (int)cudaErrorInvalidValue;
    const int n = (K + ks_max - 1) / ks_max;
    ks = ((K + n - 1) / n + E - 1) / E * E;
  }
  const size_t smem = smem_of(ks, K > ks ? 2 : 1);
  dim3 grid((unsigned)blocks(r_log2) / n_lane_blocks, n_lane_blocks);
#define FS_DD_SPLIT(C)                                                    \
  ell_dd_split_kernel<VALUED, C><<<grid, DD_THREADS, smem, st>>>(         \
      cols, vh, vl, x2, out_hi, out_lo, nb, K, k_rows, ldx, tpr_log2,     \
      r_log2, ks)
  if (cpb == 16) {
    FS_DD_SPLIT(16);
  } else if (cpb == 8) {
    FS_DD_SPLIT(8);
  } else {
    FS_DD_SPLIT(4);
  }
#undef FS_DD_SPLIT
  return 0;
}

}  // namespace

extern "C" {

// cols: int32 (nb, K); vh, vl: f32 (nb, K), unused (may be null) when
// valued = 0; x2: f32 (2·k_rows, ldx), every column < k_rows; out_hi,
// out_lo: f32 (nb, ldx).
int fs_ell_dd(const int32_t* cols, const float* vh, const float* vl,
              const float* x2, float* out_hi, float* out_lo, int nb, int K,
              int k_rows, int ldx, int valued, void* stream) {
  if (nb > 0 && ldx > 0) {
    int tpr_log2 = 0;
    while ((1 << tpr_log2) < ldx && tpr_log2 < 5) ++tpr_log2;
    const int n_lane_blocks = (ldx + (1 << tpr_log2) - 1) >> tpr_log2;
    if (n_lane_blocks > 65535) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const int rc =
        valued ? launch_dd<true>(cols, vh, vl, x2, out_hi, out_lo, nb, K,
                                 k_rows, ldx, tpr_log2, n_lane_blocks, st)
               : launch_dd<false>(cols, vh, vl, x2, out_hi, out_lo, nb, K,
                                  k_rows, ldx, tpr_log2, n_lane_blocks, st);
    if (rc) return rc;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
