// Hand-written Hopper (sm_90a) kernels for the f32 ELL gather engine.
//
// Three kernels, each the CUDA counterpart of one Pallas TPU kernel in
// fastsparse/ops/pallas/ell_spmm.py, and a fourth that runs every part of
// a narrow product in one launch:
//
//   fs_ell_bucket  <- ell_bucket_spmm   one ELL bucket:
//                                       Y[r] = sum_k v[r,k] * X[col[r,k]]
//                                       (all five bodies: _body, _body_unit,
//                                       _body_full, _body_full_packed,
//                                       _body_unit_packed)
//   fs_ell_sweep   <- ell_sweep_spmm    packed unit gather over several
//                                       width classes in one launch, rows
//                                       in sub-part order
//   fs_ell_smem    <- ell_bucket_spmm_smem  one whole bucket in one launch
//                                       (_body_smem): the chunked order at
//                                       any width, each row group's
//                                       indices (and values) staged in
//                                       shared memory
//   fs_ell_table   <- (no Pallas kernel: the reference launches
//                      ell_bucket_spmm or ell_sweep_spmm once a part)
//                                       every part of a product at X widths
//                                       <= 8 in one launch, over a device
//                                       table of work tiles
//
// Every launcher takes raw device pointers, sizes and a cudaStream_t, runs
// on that stream, allocates nothing and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
//
// Bound on this card: device-memory (and L2) bytes. Each slot reads its
// index (4 B, or 2 B packed), its value (4 B, valued mode) and one X row
// of N floats; each output row is written once. There are no reductions
// across threads and no tensor-core work. The X rows a bucket gathers are
// scattered, so they come from L2 (50 MB) once a panel is warm: at N=128
// one slot moves a 512 B X row through L2, and the kernel's time is the
// L2 gather traffic rather than the device-memory bytes of the bound.
//
// Design: threads run along the N lanes of X, a row's lanes split over
// TPR = min(32, next_pow2(N/V)) threads that each own V consecutive lanes
// (V = 4, one 16-byte load, when N is a multiple of 4 and the buffers are
// 16-byte aligned; else V = 1). At N = 128 one warp owns one bucket row and
// each gathered X row is one fully coalesced 512 B load; at N = 1 (SpMV)
// a thread owns a row. Each thread reads its row's indices (and values)
// itself, in place of the TPU's scalar prefetch, and X through L2: the
// TPU kernel's "X resident in VMEM" does not translate (a 21,889-row
// panel at 128 lanes is 11.2 MB against 227 KB of shared memory).
//
// Lane padding: the wrapper pads X to N rounded up to 4 lanes (N itself
// below 4), not to the TPU's 128-lane blocks, which would move 128x the X
// bytes at N = 1. The slot layout, the plan and the real columns are the
// reference's.
//
// Narrow body (ell_narrow_kernel), for X of at most 8 lanes (SpMV and the
// narrow CG widths). The lane split above gives a row one thread at N = 1,
// so a 7,808-row bucket would be 31 CTAs on 132 SMs, each thread walking
// its row in 4-entry trips of an index/value load and a dependent X load:
// ~32 round trips at K = 64. The narrow body gives a row four threads, thread j owning accumulator j (entries j, j+4, ... of
// every chunk), and each of them the row's TPR lane threads, so a row
// takes 4·TPR threads and a CTA 128 threads: that bucket is 244 CTAs.
// A thread walks a step of up to NARROW_SLOTS of its entries (whole
// chunks: a full row of K <= 64, 16 / ceil(KB/4) chunks of a chunked
// row) in three unrolled passes: all indices and values, then all X
// loads, then the dependent adds, so a step costs two round trips. At
// each chunk's end every thread of the group reads the four accumulators
// through __shfl_sync and joins them in order, ((a0 + a1) + a2) + a3, a
// chain and not a tree (all compute the same sum; thread j = 0 stores
// it), and a chunked body adds that sum into its zeroed output in chunk
// order: the reference's arithmetic, bit for bit. A warp's index load
// reads 16 contiguous bytes of each of its rows (at N = 1, 8 rows).
//
// Arithmetic, the reference's in the reference's order: four accumulators
// per row, entry u of a chunk going to accumulator u % 4 (in packed mode
// pair u's c0 is entry 2u, its c1 entry 2u+1), combined as
// ((acc0 + acc1) + acc2) + acc3. A whole-row body (K <= 64, and every
// sweep part) stores that sum; a chunked body adds each KB-entry chunk's
// sum into a zeroed output in chunk order. Products x*v are rounded before
// the add (explicit _rn intrinsics, and the library is built with
// --fmad=false). The accumulators start at +0, which gives the reference's
// values up to the sign of a zero result.
//
// fs_ell_smem (the TPU kernel's (1, G, K) SMEM index blocks) stages each
// block's rows' indices (and values) in shared memory slice by slice, KS
// entries a slice (a multiple of KB, so slices end on chunk boundaries),
// and adds the slice's chunk sums into its running output in chunk order,
// exactly _body_smem's order (the chunked body's: the output starts at +0
// and every chunk's sum is added, so a zero result is +0 as in the
// reference). Whole-K staging would not fit: K = 4096 valued or 8192 unit
// is 256 KB for 8 rows, over the 227 KB a block may hold. Bound: bytes,
// as fs_ell_bucket; what holds it at narrow X is the latency of each
// row's chain of loads, not the bytes.
//
// At X widths <= 8 (ell_smem_narrow_kernel) it runs the narrow body's
// threads: four a row (accumulator j), 128 a block, so at N = 1 a block
// holds 32 rows and config A's 7,808-row bucket runs on 244 blocks. The
// slice arrives by Hopper's bulk copy: one cp.async.bulk per row and
// array (a row's slice is contiguous) completing on the stage's mbarrier,
// with the next slice in flight while this one is read (two stages when K
// takes more than one slice); rows whose bytes or buffers are not 16-byte
// aligned take 8- or 4-byte cp.async instead (the launcher chooses). An
// index then costs no round trip in a thread's dependent chain: a step
// issues all of its X gathers from the staged indices, one round trip
// where #9's narrow body pays two. Rows in shared memory are ks entries
// padded to a stride of 4 mod 32 words, so a warp's 8 rows x 4
// accumulator threads read 32 banks. Two stages of indices and values fit
// 48 KB, the dynamic shared memory a block gets without opting in.
//
// At wider X (ell_smem_kernel) one block owns R = 256 / TPR rows and one
// lane range, with the lane split above; the block copies the slice with
// coalesced loads between two barriers, and a row's stride in shared
// memory is KS + 1 words (at one thread a row, 32 rows read 32 banks).
//
// fs_ell_table (ell_table_kernel). The reference's SMEM budget cuts each
// bucket into parts of at most 64Ki valued entries, and launching #9 once
// a part spent ~4 us of launch, ramp and drain on each ~0.5 MB part (300
// of them in the 250,000-square power-law SpMV: 1.19 ms for 108 MB). Here
// the host builds, once per matrix and lane count, a table of work tiles
// (a run of rows of one part, about 2048 / lanes slots each, in the
// layout's order), and one launch runs a block a tile. Bound: bytes (each
// slot's index and value once, each output row written once, X once); the
// X gathers are scattered 4-byte reads at N = 1, served by L2 and L1.
// A tile's rows are one contiguous span of index words and one of values:
// one bulk copy each (cp.async.bulk on an mbarrier) into shared memory,
// where #9 read each row at a stride of K. Then every slot's product (x·v,
// rounded; unit: x) is formed from the staged words by all the block's
// threads, eight gathers in flight a thread whatever K is, and written to
// shared memory at row stride S; then each row's sum is taken from the
// products in the reference's order: one thread a row for K <= 8 (its
// four accumulators in registers, S = K | 1), else #9's four threads a row
// joined by shuffles (S = 4 mod 8), chunk by chunk for a chunked row. The
// sums are #9's and #10's, bit for bit. Rows too wide for a tile (K past
// its slots, unsplit layouts only) are walked in global memory by
// row_sum, a thread a row. One block a tile, 256 threads, 64 registers a
// thread at N = 1 (four blocks an SM): on an H100 a persistent grid with
// the next tile's copy in flight (80 registers, three blocks an SM),
// 128-thread blocks, and register caps of 48 or 40 (spills) all ran the
// 250,000-square SpMV slower.
//
// fs_ell_table's f64 mode (f64 = 1; ell_table_kernel<double, ...>) runs a
// float64 product the same way: f64 values staged by the same bulk copy,
// f64 X, every slot's product (__dmul_rn) and each row's sum (__dadd_rn)
// in the same order, 16-byte double2 lanes at even widths. The TPU
// reference computes f64 in double-word f32 arithmetic (ell_dd.cu), which
// moves the same bytes at ~20x the arithmetic; this card has native f64.
// Bound: bytes, 12 a slot (index and value) where the f32 mode moves 8.
// The kernel's chunk_sum, row_sum and their helpers are generic in the
// value type, so the f32 bodies compile to what they were.

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int ELL_THREADS = 256;
// the narrow body: X lanes it takes, threads per CTA, entries per step
constexpr int NARROW_MAX_LANES = 8;
constexpr int NARROW_THREADS = 128;
constexpr int NARROW_SLOTS = 16;
constexpr int SWEEP_MAX_PARTS = 128;
// staged index words (and value words) per fs_ell_smem block: 20 KB each
constexpr int SMEM_STAGE_WORDS = 5120;
// the narrow smem body: staged words per array and stage (two stages of
// indices and values stay within the 48 KB a block gets without opt-in)
constexpr int SMEM_NARROW_STAGE_WORDS = 3040;

// the sweep's static part table, passed by value as a grid constant
struct SweepParts {
  int n;
  int row0[SWEEP_MAX_PARTS + 1];  // first output row of each part; [n] = total
  int k2[SWEEP_MAX_PARTS];        // packed pairs per row
  int wbase[SWEEP_MAX_PARTS];     // first packed word of the part
};

// Rounded adds and products of the value type: f32, or f64 in the table
// kernel's f64 mode (explicit _rn intrinsics: no contraction into an FMA).
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// V consecutive values of T as one load or store: 16 bytes (float4 at V =
// 4, double2 at V = 2) or one scalar (V = 1).
template <int V, typename T>
__device__ __forceinline__ void load_x(const T* __restrict__ x, size_t off,
                                       T (&r)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(x + off));
    r[0] = t.x;
    r[1] = t.y;
    r[2] = t.z;
    r[3] = t.w;
  } else if constexpr (V == 2) {
    const double2 t = __ldg(reinterpret_cast<const double2*>(x + off));
    r[0] = t.x;
    r[1] = t.y;
  } else {
    r[0] = __ldg(x + off);
  }
}

template <int V, typename T>
__device__ __forceinline__ void store_out(T* __restrict__ out, size_t off,
                                          const T (&o)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(out + off) = make_float4(o[0], o[1], o[2], o[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<double2*>(out + off) = make_double2(o[0], o[1]);
  } else {
    out[off] = o[0];
  }
}

template <int V, bool UNIT, typename T>
__device__ __forceinline__ void add_entry(T (&acc)[V], const T* __restrict__ x,
                                          int c, T v, int ldx, int col0) {
  T r[V];
  load_x<V>(x, (size_t)c * ldx + col0, r);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    acc[i] = UNIT ? add_rn(acc[i], r[i]) : add_rn(acc[i], mul_rn(r[i], v));
  }
}

// column of entry e of a row: plain int32, or half of a packed pair
// (c0 = p & 0xFFFF, c1 = p >> 16 logical)
// (GLOBAL: read through the read-only cache; else a shared-memory copy)
template <bool PACKED, bool GLOBAL>
__device__ __forceinline__ int col_at(const int32_t* __restrict__ idx, int e) {
  if constexpr (PACKED) {
    const uint32_t p = (uint32_t)(GLOBAL ? __ldg(idx + (e >> 1)) : idx[e >> 1]);
    return (e & 1) ? (int)(p >> 16) : (int)(p & 0xFFFFu);
  } else {
    return GLOBAL ? __ldg(idx + e) : idx[e];
  }
}

template <bool UNIT, bool GLOBAL, typename T>
__device__ __forceinline__ T val_at(const T* __restrict__ vals, int e) {
  if constexpr (UNIT) {
    return T(1);
  } else {
    return GLOBAL ? __ldg(vals + e) : vals[e];
  }
}

// The sum of one KB-entry chunk starting at entry t0, for lanes [col0,
// col0 + V): entry u into accumulator u % 4, ((a0 + a1) + a2) + a3.
template <int V, bool UNIT, bool PACKED, bool GLOBAL, typename T>
__device__ __forceinline__ void chunk_sum(const int32_t* __restrict__ idx,
                                          const T* __restrict__ vals,
                                          const T* __restrict__ x, int ldx,
                                          int col0, int t0, int KB,
                                          T (&s)[V]) {
  T a0[V], a1[V], a2[V], a3[V];
#pragma unroll
  for (int i = 0; i < V; ++i) a0[i] = a1[i] = a2[i] = a3[i] = T(0);
  int u = 0;
  for (; u + 4 <= KB; u += 4) {
    const int e = t0 + u;
    const int c0 = col_at<PACKED, GLOBAL>(idx, e);
    const int c1 = col_at<PACKED, GLOBAL>(idx, e + 1);
    const int c2 = col_at<PACKED, GLOBAL>(idx, e + 2);
    const int c3 = col_at<PACKED, GLOBAL>(idx, e + 3);
    const T v0 = val_at<UNIT, GLOBAL>(vals, e);
    const T v1 = val_at<UNIT, GLOBAL>(vals, e + 1);
    const T v2 = val_at<UNIT, GLOBAL>(vals, e + 2);
    const T v3 = val_at<UNIT, GLOBAL>(vals, e + 3);
    add_entry<V, UNIT>(a0, x, c0, v0, ldx, col0);
    add_entry<V, UNIT>(a1, x, c1, v1, ldx, col0);
    add_entry<V, UNIT>(a2, x, c2, v2, ldx, col0);
    add_entry<V, UNIT>(a3, x, c3, v3, ldx, col0);
  }
  // a chunk length that is not a multiple of 4 keeps its tail
  if (u < KB) {
    add_entry<V, UNIT>(a0, x, col_at<PACKED, GLOBAL>(idx, t0 + u),
                       val_at<UNIT, GLOBAL>(vals, t0 + u), ldx, col0);
  }
  if (u + 1 < KB) {
    add_entry<V, UNIT>(a1, x, col_at<PACKED, GLOBAL>(idx, t0 + u + 1),
                       val_at<UNIT, GLOBAL>(vals, t0 + u + 1), ldx, col0);
  }
  if (u + 2 < KB) {
    add_entry<V, UNIT>(a2, x, col_at<PACKED, GLOBAL>(idx, t0 + u + 2),
                       val_at<UNIT, GLOBAL>(vals, t0 + u + 2), ldx, col0);
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    s[i] = add_rn(add_rn(add_rn(a0[i], a1[i]), a2[i]), a3[i]);
  }
}

// One bucket row's K entries for lanes [col0, col0 + V): chunks of KB
// entries. full: store the single chunk's sum; else add each chunk's sum
// into a zeroed output in order.
template <int V, bool UNIT, bool PACKED, typename T>
__device__ __forceinline__ void row_sum(const int32_t* __restrict__ idx,
                                        const T* __restrict__ vals,
                                        const T* __restrict__ x, int ldx,
                                        int col0, int K, int KB, bool full,
                                        T (&o)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) o[i] = T(0);
  for (int t0 = 0; t0 < K; t0 += KB) {
    T s[V];
    chunk_sum<V, UNIT, PACKED, true>(idx, vals, x, ldx, col0, t0, KB, s);
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = full ? s[i] : add_rn(o[i], s[i]);
  }
}

template <int V, bool UNIT, bool PACKED>
__global__ void __launch_bounds__(ELL_THREADS)
ell_bucket_kernel(const int32_t* __restrict__ idx,
                  const float* __restrict__ vals,
                  const float* __restrict__ x, float* __restrict__ out, int nb,
                  int K, int KB, int full, int ldx, int tpr_log2) {
  const int tpr = 1 << tpr_log2;
  const int r = blockIdx.x * (ELL_THREADS >> tpr_log2) + (threadIdx.x >> tpr_log2);
  const int col0 = (blockIdx.y * tpr + (threadIdx.x & (tpr - 1))) * V;
  if (r >= nb || col0 >= ldx) return;
  const int kw = PACKED ? K / 2 : K;  // index words per row
  float o[V];
  row_sum<V, UNIT, PACKED>(idx + (size_t)r * kw,
                           UNIT ? nullptr : vals + (size_t)r * K, x, ldx, col0,
                           K, KB, full != 0, o);
  store_out<V>(out, (size_t)r * ldx + col0, o);
}

// The narrow body's walk over chunks [0, nchunks) of one row, the
// entries at ri (and rv), shared by ell_narrow_kernel (the row in global
// memory) and ell_smem_narrow_kernel (a slice staged in shared memory).
// Thread (row, j, q) owns accumulator j of lanes [col0, col0 + V); its
// slot n of a step is entry j + 4·(n % Q) of chunk c0 + n / Q, Q =
// ceil(KB / 4); a step holds S = NARROW_SLOTS / Q whole chunks, loaded in
// three passes (indices and values, X, the adds). At each chunk's end the
// row's threads read the four accumulators from fixed lanes (src0 is
// j = 0's) and join them in order; full: store the one chunk's sum, else
// add each chunk's sum into o in order. nchunks is uniform across the
// grid, so the joins' shuffles run in full warps.
template <int V, bool UNIT, bool PACKED, bool GLOBAL>
__device__ __forceinline__ void narrow_chunks(
    const int32_t* __restrict__ ri, const float* __restrict__ rv,
    const float* __restrict__ x, int ldx, int col0, bool live, int j,
    int KB, int nchunks, int full, int tpr_log2, int src0, float (&o)[V]) {
  const int Q = (KB + 3) >> 2;
  const int S = NARROW_SLOTS / Q;
  for (int c0 = 0; c0 < nchunks; c0 += S) {
    int col[NARROW_SLOTS];
    float v[NARROW_SLOTS];
    bool ok[NARROW_SLOTS];
    {
      int c = c0, i = 0;
#pragma unroll
      for (int n = 0; n < NARROW_SLOTS; ++n) {
        const int u = j + 4 * i;
        const int e = c * KB + u;
        ok[n] = live && c < c0 + S && c < nchunks && u < KB;
        col[n] = ok[n] ? col_at<PACKED, GLOBAL>(ri, e) : 0;
        v[n] = ok[n] ? val_at<UNIT, GLOBAL>(rv, e) : 0.0f;
        if (++i == Q) {
          i = 0;
          ++c;
        }
      }
    }
    float xr[NARROW_SLOTS][V];
#pragma unroll
    for (int n = 0; n < NARROW_SLOTS; ++n) {
      if (ok[n]) {
        load_x<V>(x, (size_t)col[n] * ldx + col0, xr[n]);
      } else {
#pragma unroll
        for (int l = 0; l < V; ++l) xr[n][l] = 0.0f;
      }
    }
    float a[V];
#pragma unroll
    for (int l = 0; l < V; ++l) a[l] = 0.0f;
    int c = c0, i = 0;
#pragma unroll
    for (int n = 0; n < NARROW_SLOTS; ++n) {
      if (ok[n]) {
#pragma unroll
        for (int l = 0; l < V; ++l) {
          a[l] = UNIT ? __fadd_rn(a[l], xr[n][l])
                      : __fadd_rn(a[l], __fmul_rn(xr[n][l], v[n]));
        }
      }
      if (++i == Q) {
        if (c < c0 + S && c < nchunks) {  // uniform: the chunk's join
#pragma unroll
          for (int l = 0; l < V; ++l) {
            const float a0 = __shfl_sync(0xffffffffu, a[l], src0);
            const float a1 = __shfl_sync(0xffffffffu, a[l], src0 + (1 << tpr_log2));
            const float a2 = __shfl_sync(0xffffffffu, a[l], src0 + (2 << tpr_log2));
            const float a3 = __shfl_sync(0xffffffffu, a[l], src0 + (3 << tpr_log2));
            const float s = __fadd_rn(__fadd_rn(__fadd_rn(a0, a1), a2), a3);
            o[l] = full ? s : __fadd_rn(o[l], s);
            a[l] = 0.0f;
          }
        }
        i = 0;
        ++c;
      }
    }
  }
}

// The narrow body (ldx <= NARROW_MAX_LANES): 4·TPR threads a row, the
// row's entries read from global memory.
template <int V, bool UNIT, bool PACKED>
__global__ void __launch_bounds__(NARROW_THREADS)
ell_narrow_kernel(const int32_t* __restrict__ idx,
                  const float* __restrict__ vals,
                  const float* __restrict__ x, float* __restrict__ out, int nb,
                  int K, int KB, int full, int ldx, int tpr_log2) {
  const int g_log2 = tpr_log2 + 2;  // 4·TPR threads a row
  const int r = blockIdx.x * (NARROW_THREADS >> g_log2) + (threadIdx.x >> g_log2);
  const int j = (threadIdx.x >> tpr_log2) & 3;
  const int q = threadIdx.x & ((1 << tpr_log2) - 1);
  const int col0 = q * V;
  const bool live = r < nb && col0 < ldx;
  const int src0 = (threadIdx.x & 31 & ~((1 << g_log2) - 1)) + q;  // j = 0's lane
  const int32_t* ri = idx + (size_t)(live ? r : 0) * (PACKED ? K / 2 : K);
  const float* rv = UNIT ? nullptr : vals + (size_t)(live ? r : 0) * K;
  float o[V];
#pragma unroll
  for (int i = 0; i < V; ++i) o[i] = 0.0f;
  narrow_chunks<V, UNIT, PACKED, true>(ri, rv, x, ldx, col0, live, j, KB,
                                       K / KB, full, tpr_log2, src0, o);
  if (live && j == 0) store_out<V>(out, (size_t)r * ldx + col0, o);
}

template <int V>
__global__ void __launch_bounds__(ELL_THREADS)
ell_sweep_kernel(const int32_t* __restrict__ words, const float* __restrict__ x,
                 float* __restrict__ out, const __grid_constant__ SweepParts parts,
                 int ldx, int tpr_log2) {
  const int tpr = 1 << tpr_log2;
  const int r = blockIdx.x * (ELL_THREADS >> tpr_log2) + (threadIdx.x >> tpr_log2);
  const int col0 = (blockIdx.y * tpr + (threadIdx.x & (tpr - 1))) * V;
  if (r >= parts.row0[parts.n] || col0 >= ldx) return;
  int p = 0;
  while (r >= parts.row0[p + 1]) ++p;
  const int K2 = parts.k2[p];
  float o[V];
  row_sum<V, true, true>(words + parts.wbase[p] + (size_t)(r - parts.row0[p]) * K2,
                         static_cast<const float*>(nullptr), x, ldx, col0,
                         2 * K2, 2 * K2, true, o);
  store_out<V>(out, (size_t)r * ldx + col0, o);
}

// One whole bucket (fs_ell_smem): R = ELL_THREADS >> tpr_log2 rows per
// block, K walked in slices of ks entries staged in shared memory.
template <int V, bool UNIT>
__global__ void __launch_bounds__(ELL_THREADS)
ell_smem_kernel(const int32_t* __restrict__ idx, const float* __restrict__ vals,
                const float* __restrict__ x, float* __restrict__ out, int nb,
                int K, int KB, int ks, int ldx, int tpr_log2) {
  __shared__ int32_t s_idx[SMEM_STAGE_WORDS];
  __shared__ float s_val[UNIT ? 1 : SMEM_STAGE_WORDS];
  const int tpr = 1 << tpr_log2;
  const int rows_blk = ELL_THREADS >> tpr_log2;
  const int row0 = blockIdx.x * rows_blk;
  const int lr = threadIdx.x >> tpr_log2;
  const int r = row0 + lr;
  const int col0 = (blockIdx.y * tpr + (threadIdx.x & (tpr - 1))) * V;
  const bool active = r < nb && col0 < ldx;
  const int nrows = min(rows_blk, nb - row0);
  float o[V];
#pragma unroll
  for (int i = 0; i < V; ++i) o[i] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += ks) {
    const int kw = min(ks, K - k0);  // a multiple of KB
    const int stride = kw + 1;
    __syncthreads();  // the previous slice is consumed
    for (int i = threadIdx.x; i < nrows * kw; i += ELL_THREADS) {
      const int rr = i / kw;
      const int kk = i - rr * kw;
      const size_t g = (size_t)(row0 + rr) * K + k0 + kk;
      s_idx[rr * stride + kk] = __ldg(idx + g);
      if constexpr (!UNIT) s_val[rr * stride + kk] = __ldg(vals + g);
    }
    __syncthreads();
    if (active) {
      const int32_t* ri = s_idx + lr * stride;
      const float* rv = UNIT ? nullptr : s_val + lr * stride;
      for (int t0 = 0; t0 < kw; t0 += KB) {
        float s[V];
        chunk_sum<V, UNIT, false, false>(ri, rv, x, ldx, col0, t0, KB, s);
#pragma unroll
        for (int i = 0; i < V; ++i) o[i] = __fadd_rn(o[i], s[i]);
      }
    }
  }
  if (active) store_out<V>(out, (size_t)r * ldx + col0, o);
}

// words per staged row of a slice of ks entries: the least stride >= ks
// with stride % 32 == 4 (16-byte rows; at N = 1 a warp's 8 rows x 4
// accumulator threads then read 32 different banks)
__host__ __device__ __forceinline__ int narrow_stage_stride(int ks) {
  return ks + (36 - ks % 32) % 32;
}

// One whole bucket at X widths <= NARROW_MAX_LANES (fs_ell_smem): the
// narrow body's threads, the block's rows' entries staged slice by slice
// in shared memory, two slices deep when K takes more than one. CPB = 16:
// one bulk copy per row and array, completing on the stage's mbarrier;
// CPB = 8 or 4: cp.async of that many bytes, completing by commit group.
template <int V, bool UNIT, int CPB>
__global__ void __launch_bounds__(NARROW_THREADS)
ell_smem_narrow_kernel(const int32_t* __restrict__ idx,
                       const float* __restrict__ vals,
                       const float* __restrict__ x, float* __restrict__ out,
                       int nb, int K, int KB, int ks, int ldx, int tpr_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);  // one per stage
  const int g_log2 = tpr_log2 + 2;  // 4·TPR threads a row
  const int rows_blk = NARROW_THREADS >> g_log2;
  const int stride = narrow_stage_stride(ks);
  const int stage_words = rows_blk * stride;
  const int nst = K > ks ? 2 : 1;
  int32_t* s_idx = reinterpret_cast<int32_t*>(smem_raw + 16);  // [nst][...]
  float* s_val = reinterpret_cast<float*>(s_idx + nst * stage_words);
  const int row0 = blockIdx.x * rows_blk;
  const int nrows = min(rows_blk, nb - row0);
  const int lr = threadIdx.x >> g_log2;
  const int r = row0 + lr;
  const int j = (threadIdx.x >> tpr_log2) & 3;
  const int q = threadIdx.x & ((1 << tpr_log2) - 1);
  const int col0 = q * V;
  const bool live = r < nb && col0 < ldx;
  const int src0 = (threadIdx.x & 31 & ~((1 << g_log2) - 1)) + q;  // j = 0's lane

  if constexpr (CPB == 16) {
    if (threadIdx.x == 0) {
      acp::mbar_init(&bar[0], 1);
      acp::mbar_init(&bar[1], 1);
      acp::fence_mbar_init();
    }
    __syncthreads();
  }
  // the block's rows' entries [k0, k0 + kw) into stage st
  auto stage = [&](int st, int k0, int kw) {
    int32_t* di = s_idx + st * stage_words;
    float* dv = s_val + st * stage_words;
    if constexpr (CPB == 16) {
      if (threadIdx.x < 32) {
        if (threadIdx.x == 0) {
          acp::mbar_expect_tx(&bar[st], nrows * kw * (UNIT ? 4 : 8));
        }
        __syncwarp();
        acp::fence_proxy_async();
        for (int rr = threadIdx.x; rr < nrows; rr += 32) {
          const size_t g = (size_t)(row0 + rr) * K + k0;
          acp::bulk_g2s(di + rr * stride, idx + g, kw * 4, &bar[st]);
          if constexpr (!UNIT) {
            acp::bulk_g2s(dv + rr * stride, vals + g, kw * 4, &bar[st]);
          }
        }
      }
    } else {
      constexpr int E = CPB / 4;
      const int per_row = kw / E;
      for (int i = threadIdx.x; i < nrows * per_row; i += NARROW_THREADS) {
        const int rr = i / per_row;
        const int c = (i - rr * per_row) * E;
        const size_t g = (size_t)(row0 + rr) * K + k0 + c;
        acp::cp_async<CPB>(di + rr * stride + c, idx + g);
        if constexpr (!UNIT) acp::cp_async<CPB>(dv + rr * stride + c, vals + g);
      }
      acp::cp_async_commit();
    }
  };

  float o[V];
#pragma unroll
  for (int i = 0; i < V; ++i) o[i] = 0.0f;
  stage(0, 0, min(ks, K));
  for (int sl = 0, k0 = 0; k0 < K; ++sl, k0 += ks) {
    const int st = sl & (nst - 1);
    const bool more = k0 + ks < K;
    // the other stage was consumed before the last slice's barrier
    if (more) stage(st ^ 1, k0 + ks, min(ks, K - k0 - ks));
    if constexpr (CPB == 16) {
      acp::mbar_wait(&bar[st], (sl >> 1) & 1);
    } else {
      if (more) {
        acp::cp_async_wait<1>();
      } else {
        acp::cp_async_wait<0>();
      }
      __syncthreads();
    }
    narrow_chunks<V, UNIT, false, false>(
        s_idx + st * stage_words + lr * stride,
        s_val + st * stage_words + lr * stride, x, ldx, col0, live, j, KB,
        min(ks, K - k0) / KB, 0, tpr_log2, src0, o);
    __syncthreads();  // stage st is free for the slice after next
  }
  if (live && j == 0) store_out<V>(out, (size_t)r * ldx + col0, o);
}

// ---------------------------------------------------------------------------
// fs_ell_table: every part of a narrow product in one launch, one block a
// tile of the host-built table (ops/kernels/ell_spmm.py: `ell_table`).

// one work tile: a run of rows of one part (rows of one bucket, their
// output rows consecutive in the slot stream); 48 bytes, the host's int64
// columns (idx, vals, out_row | x_row0 << 32, n_rows | n_src << 32,
// K | KB << 32, flags)
struct EllTile {
  const int32_t* idx;  // the first row's index words (packed pairs: words)
  const void* vals;    // its first value (f32, or f64 in the f64 mode);
                       // null in unit mode
  int out_row;         // the first row's place in the output slot stream
  int x_row0;          // first row of the part's X panel in x
  int n_rows;          // rows written
  int n_src;           // of them read from the bucket (the rest: +0)
  int K;               // entries a row
  int KB;              // entries a chunk (K: the whole-row body)
  int flags;           // TILE_*
  int unused;
};
constexpr int TILE_FULL = 1;    // store the one chunk's sum
constexpr int TILE_PACKED = 2;  // 16-bit column pairs
constexpr int TILE_STAGED = 4;  // rows staged in shared memory (else walked
                                // in global memory, rows wider than a tile)
constexpr int TABLE_THREADS = 256;
constexpr int TABLE_BATCH = 8;  // products a thread has in flight

// elements of T between staged rows' products: K | 1 when a thread owns a
// row (K <= 8: 32 rows a warp on 32 banks; at 8-byte elements a half-warp's
// 16 rows on 16 bank pairs), else the least stride >= K that is 4 mod 8 (8
// rows a warp x 4 accumulator threads on 32 banks; 4 rows x 4 on 16 bank
// pairs a half-warp at 8 bytes)
__host__ __device__ __forceinline__ int table_stride(int K) {
  return K <= 8 ? (K | 1) : K + ((12 - K % 8) % 8);
}

template <int V, typename T>
__device__ __forceinline__ void load_s(const T* p, T (&r)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r[0] = t.x;
    r[1] = t.y;
    r[2] = t.z;
    r[3] = t.w;
  } else if constexpr (V == 2) {
    const double2 t = *reinterpret_cast<const double2*>(p);
    r[0] = t.x;
    r[1] = t.y;
  } else {
    r[0] = *p;
  }
}

// Pass 1 of a staged tile: every slot's product x[col]·v (unit: x[col]),
// rounded, into prod at (r·S + u)·ldx, slot w = r·K + u read from the staged
// words. Each thread takes slots w = tid + TABLE_THREADS·i, TABLE_BATCH of
// them at a time: their indices and values, then all their X loads, then the
// products, so a thread has TABLE_BATCH gathers in flight.
template <typename T, int V, bool UNIT, bool PACKED>
__device__ __forceinline__ void table_products(
    const int32_t* __restrict__ si, const T* __restrict__ sv,
    T* __restrict__ prod, const T* __restrict__ xp, int ldx, int nq,
    int n_slots, int K, int S) {
  int r = threadIdx.x / K, u = threadIdx.x - r * K;
  const int dr = TABLE_THREADS / K, du = TABLE_THREADS - dr * K;
  for (int w0 = threadIdx.x; w0 < n_slots; w0 += TABLE_BATCH * TABLE_THREADS) {
    int col[TABLE_BATCH], pos[TABLE_BATCH];
    T v[TABLE_BATCH];
    bool ok[TABLE_BATCH];
#pragma unroll
    for (int b = 0; b < TABLE_BATCH; ++b) {
      const int w = w0 + b * TABLE_THREADS;
      ok[b] = w < n_slots;
      col[b] = ok[b] ? col_at<PACKED, false>(si, w) : 0;
      v[b] = ok[b] ? val_at<UNIT, false>(sv, w) : T(0);
      pos[b] = (r * S + u) * ldx;
      u += du;
      r += dr;
      if (u >= K) {
        u -= K;
        ++r;
      }
    }
    for (int q = 0; q < nq; ++q) {
      T xr[TABLE_BATCH][V];
#pragma unroll
      for (int b = 0; b < TABLE_BATCH; ++b) {
        if (ok[b]) load_x<V>(xp, (size_t)col[b] * ldx + q * V, xr[b]);
      }
#pragma unroll
      for (int b = 0; b < TABLE_BATCH; ++b) {
        if (!ok[b]) continue;
        T p[V];
#pragma unroll
        for (int l = 0; l < V; ++l) p[l] = UNIT ? xr[b][l] : mul_rn(xr[b][l], v[b]);
        store_out<V>(prod, pos[b] + q * V, p);
      }
    }
  }
}

// Pass 2, K <= 8: a thread a (row, lane group) sums the row's products in
// the reference's order (entry u into accumulator u % 4, ((a0 + a1) + a2) +
// a3) and stores it; rows past n_src store +0.
template <typename T, int V>
__device__ __forceinline__ void table_rows_small(const T* __restrict__ prod,
                                                 T* __restrict__ out, int ldx,
                                                 int nq, int n_rows, int n_src,
                                                 int K, int S) {
  for (int it = threadIdx.x; it < n_rows * nq; it += TABLE_THREADS) {
    const int r = nq == 1 ? it : it / nq;
    const int q = it - r * nq;
    T o[V];
#pragma unroll
    for (int l = 0; l < V; ++l) o[l] = T(0);
    if (r < n_src) {
      T a[4][V];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int l = 0; l < V; ++l) a[k][l] = T(0);
      }
      const T* p = prod + (size_t)r * S * ldx + q * V;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (e < K) {
          T t[V];
          load_s<V>(p + e * ldx, t);
#pragma unroll
          for (int l = 0; l < V; ++l) a[e & 3][l] = add_rn(a[e & 3][l], t[l]);
        }
      }
#pragma unroll
      for (int l = 0; l < V; ++l) {
        o[l] = add_rn(add_rn(add_rn(a[0][l], a[1][l]), a[2][l]), a[3][l]);
      }
    }
    store_out<V>(out, (size_t)r * ldx + q * V, o);
  }
}

// Pass 2, K > 8: four threads a row (thread j sums entries j, j + 4, ... of
// each chunk) times 2^tq_log2 lane threads; at each chunk's end the row's
// threads read the four sums through __shfl_sync and join them in order,
// and a chunked row adds each chunk's sum into its zeroed output in chunk
// order. The loops are uniform across the block (every row of a tile has
// the same K and KB), so the shuffles run in full warps; rows past n_src
// join zeros and store +0.
template <typename T, int V>
__device__ __forceinline__ void table_rows_quad(const T* __restrict__ prod,
                                                T* __restrict__ out, int ldx,
                                                int nq, int tq_log2, int n_rows,
                                                int n_src, int S, int KB,
                                                int nchunks, bool full) {
  const int g_log2 = tq_log2 + 2;
  const int rows_pass = TABLE_THREADS >> g_log2;
  const int lr = threadIdx.x >> g_log2;
  const int j = (threadIdx.x >> tq_log2) & 3;
  const int q = threadIdx.x & ((1 << tq_log2) - 1);
  const int src0 = (threadIdx.x & 31 & ~((1 << g_log2) - 1)) + q;  // j = 0's lane
  for (int r0 = 0; r0 < n_rows; r0 += rows_pass) {
    const int r = r0 + lr;
    const bool live = r < n_src && q < nq;
    const T* p = prod + (size_t)(live ? r : 0) * S * ldx + q * V;
    T o[V];
#pragma unroll
    for (int l = 0; l < V; ++l) o[l] = T(0);
    for (int c = 0; c < nchunks; ++c) {
      T a[V];
#pragma unroll
      for (int l = 0; l < V; ++l) a[l] = T(0);
      if (live) {
        for (int e = c * KB + j; e < (c + 1) * KB; e += 4) {
          T t[V];
          load_s<V>(p + e * ldx, t);
#pragma unroll
          for (int l = 0; l < V; ++l) a[l] = add_rn(a[l], t[l]);
        }
      }
#pragma unroll
      for (int l = 0; l < V; ++l) {
        const T a0 = __shfl_sync(0xffffffffu, a[l], src0);
        const T a1 = __shfl_sync(0xffffffffu, a[l], src0 + (1 << tq_log2));
        const T a2 = __shfl_sync(0xffffffffu, a[l], src0 + (2 << tq_log2));
        const T a3 = __shfl_sync(0xffffffffu, a[l], src0 + (3 << tq_log2));
        const T s = add_rn(add_rn(add_rn(a0, a1), a2), a3);
        o[l] = full ? s : add_rn(o[l], s);
      }
    }
    if (r < n_rows && q < nq && j == 0) store_out<V>(out, (size_t)r * ldx + q * V, o);
  }
}

// A tile whose rows do not fit the stage (K past the tile's slots, unsplit
// layouts only): a thread a (row, lane group) walks its row's chunks in
// global memory (row_sum: the lane-split body's order, the same sums).
template <typename T, int V, bool UNIT, bool PACKED>
__device__ __forceinline__ void table_rows_global(const EllTile& t,
                                                  const T* __restrict__ xp,
                                                  T* __restrict__ out,
                                                  int ldx, int nq) {
  const int kw = PACKED ? t.K / 2 : t.K;
  const T* vals = static_cast<const T*>(t.vals);
  for (int it = threadIdx.x; it < t.n_rows * nq; it += TABLE_THREADS) {
    const int r = it / nq;
    const int q = it - r * nq;
    T o[V];
#pragma unroll
    for (int l = 0; l < V; ++l) o[l] = T(0);
    if (r < t.n_src) {
      row_sum<V, UNIT, PACKED>(t.idx + (size_t)r * kw,
                               UNIT ? nullptr : vals + (size_t)r * t.K, xp, ldx,
                               q * V, t.K, t.KB, (t.flags & TILE_FULL) != 0, o);
    }
    store_out<V>(out, (size_t)r * ldx + q * V, o);
  }
}

template <typename T, int V, bool UNIT, bool PACKED>
__device__ __forceinline__ void table_tile(const EllTile& t, const int32_t* si,
                                           const T* sv, T* prod,
                                           const T* __restrict__ xp,
                                           T* __restrict__ out, int ldx,
                                           int nq, int tq_log2) {
  if (!(t.flags & TILE_STAGED)) {
    table_rows_global<T, V, UNIT, PACKED>(t, xp, out, ldx, nq);
    return;
  }
  const int S = table_stride(t.K);
  table_products<T, V, UNIT, PACKED>(si, sv, prod, xp, ldx, nq, t.n_src * t.K,
                                     t.K, S);
  __syncthreads();
  if (t.K <= 8) {
    table_rows_small<T, V>(prod, out, ldx, nq, t.n_rows, t.n_src, t.K, S);
  } else {
    table_rows_quad<T, V>(prod, out, ldx, nq, tq_log2, t.n_rows, t.n_src, S,
                          t.KB, t.K / t.KB, (t.flags & TILE_FULL) != 0);
  }
}

// One block a tile. A staged tile's index words and values are one
// contiguous span each (its rows, row-major): one bulk copy each, from the
// span's start rounded down to 16 bytes to its end rounded up (the extra
// words share a 16-byte granule with the span, so they lie in its
// allocation, and are not read), completing on one mbarrier. Shared memory:
// the barrier, idx_cap index words, val_cap values and prod_cap products
// (elements of T, multiples of 4, so each array starts on 16 bytes).
template <typename T, int V, bool UNIT>
__global__ void __launch_bounds__(TABLE_THREADS)
ell_table_kernel(const EllTile* __restrict__ tiles, const T* __restrict__ x,
                 T* __restrict__ out, int ldx, int idx_cap, int val_cap,
                 int tq_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  int32_t* s_idx = reinterpret_cast<int32_t*>(smem_raw + 16);
  T* s_val = reinterpret_cast<T*>(s_idx + idx_cap);
  T* prod = s_val + val_cap;
  const EllTile t = tiles[blockIdx.x];
  const bool packed = UNIT && (t.flags & TILE_PACKED);
  const int nq = (ldx + V - 1) / V;
  const T* xp = x + (size_t)t.x_row0 * ldx;
  T* op = out + (size_t)t.out_row * ldx;
  int hi = 0, hv = 0;
  if (t.flags & TILE_STAGED) {
    const uintptr_t ia = reinterpret_cast<uintptr_t>(t.idx);
    const uintptr_t va = reinterpret_cast<uintptr_t>(t.vals);
    hi = (int)(ia & 15) >> 2;
    hv = (int)(va & 15) / (int)sizeof(T);
    const uint32_t ib = ((hi + t.n_src * (packed ? t.K / 2 : t.K)) * 4 + 15) & ~15u;
    const uint32_t vb =
        UNIT ? 0u : ((hv + t.n_src * t.K) * (uint32_t)sizeof(T) + 15) & ~15u;
    if (threadIdx.x == 0) {
      acp::mbar_init(bar, 1);
      acp::fence_mbar_init();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      if (t.n_src > 0) {
        acp::fence_proxy_async();
        acp::mbar_expect_tx(bar, ib + vb);
        acp::bulk_g2s(s_idx, reinterpret_cast<const void*>(ia & ~(uintptr_t)15), ib, bar);
        if constexpr (!UNIT) {
          acp::bulk_g2s(s_val, reinterpret_cast<const void*>(va & ~(uintptr_t)15), vb,
                        bar);
        }
      } else {
        acp::mbar_arrive(bar);
      }
    }
    acp::mbar_wait(bar, 0);
  }
  if constexpr (UNIT) {  // packed pairs are unit-only
    if (packed) {
      table_tile<T, V, true, true>(t, s_idx + hi, s_val + hv, prod, xp, op, ldx,
                                   nq, tq_log2);
      return;
    }
  }
  table_tile<T, V, UNIT, false>(t, s_idx + hi, s_val + hv, prod, xp, op, ldx, nq,
                                tq_log2);
}

template <typename T, int V, bool UNIT>
int launch_table(const EllTile* tiles, int n_tiles, const void* x, void* out,
                 int ldx, int idx_cap, int val_cap, size_t smem, int tq_log2,
                 cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ell_table_kernel<T, V, UNIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ell_table_kernel<T, V, UNIT><<<n_tiles, TABLE_THREADS, smem, st>>>(
      tiles, static_cast<const T*>(x), static_cast<T*>(out), ldx, idx_cap,
      val_cap, tq_log2);
  return (int)cudaGetLastError();
}

// lane split: V lanes per thread, TPR = 2^tpr_log2 threads per row
struct LaneSplit {
  int vec4;
  int tpr_log2;
  int n_col_blocks;
};

LaneSplit lane_split(const void* x, const void* out, int ldx) {
  LaneSplit s;
  s.vec4 = (ldx % 4 == 0) && ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const int nvec = s.vec4 ? ldx / 4 : ldx;
  s.tpr_log2 = 0;
  while ((1 << s.tpr_log2) < nvec && s.tpr_log2 < 5) ++s.tpr_log2;
  s.n_col_blocks = (nvec + (1 << s.tpr_log2) - 1) >> s.tpr_log2;
  return s;
}

template <int V>
int launch_narrow(const int32_t* idx, const float* vals, const float* x,
                  float* out, int nb, int K, int KB, int full, int unit,
                  int packed, int ldx, const LaneSplit& s, cudaStream_t st) {
  const int rows_per_block = NARROW_THREADS >> (s.tpr_log2 + 2);
  const unsigned int grid = (nb + rows_per_block - 1) / rows_per_block;
  if (unit && packed) {
    ell_narrow_kernel<V, true, true><<<grid, NARROW_THREADS, 0, st>>>(
        idx, vals, x, out, nb, K, KB, full, ldx, s.tpr_log2);
  } else if (unit) {
    ell_narrow_kernel<V, true, false><<<grid, NARROW_THREADS, 0, st>>>(
        idx, vals, x, out, nb, K, KB, full, ldx, s.tpr_log2);
  } else if (!packed) {
    ell_narrow_kernel<V, false, false><<<grid, NARROW_THREADS, 0, st>>>(
        idx, vals, x, out, nb, K, KB, full, ldx, s.tpr_log2);
  } else {
    return (int)cudaErrorInvalidValue;  // packed pairs are unit-only
  }
  return 0;
}

// fs_ell_smem at ldx <= NARROW_MAX_LANES. The copy: bulk (16-byte rows and
// buffers), else cp.async of 8 or 4 bytes. The slice: K whole when the
// block's rows fit a stage, else the most entries that fit, a multiple of
// KB (slices end on chunk boundaries) and of the copy's entries.
template <int V>
int launch_smem_narrow(const int32_t* idx, const float* vals, const float* x,
                       float* out, int nb, int K, int KB, int unit, int ldx,
                       const LaneSplit& s, cudaStream_t st) {
  const int rows_blk = NARROW_THREADS >> (s.tpr_log2 + 2);
  auto aligned = [&](int b) {
    return (K * 4) % b == 0 && (uintptr_t)idx % b == 0 &&
           (unit || (uintptr_t)vals % b == 0);
  };
  const int cpb = aligned(16) ? 16 : aligned(8) ? 8 : 4;
  int step = KB;  // lcm(KB, entries a copy moves)
  while (step % (cpb / 4)) step += KB;
  int ks = K;
  if (rows_blk * narrow_stage_stride(K) > SMEM_NARROW_STAGE_WORDS) {
    ks = (SMEM_NARROW_STAGE_WORDS / rows_blk / step) * step;
    while (ks > 0 && rows_blk * narrow_stage_stride(ks) > SMEM_NARROW_STAGE_WORDS) {
      ks -= step;
    }
  }
  if (ks <= 0) return (int)cudaErrorInvalidValue;
  const int nst = K > ks ? 2 : 1;
  const size_t smem =
      16 + (size_t)nst * rows_blk * narrow_stage_stride(ks) * 4 * (unit ? 1 : 2);
  const unsigned int grid = (nb + rows_blk - 1) / rows_blk;
#define FS_SMEM_NARROW(U, C)                                                \
  ell_smem_narrow_kernel<V, U, C><<<grid, NARROW_THREADS, smem, st>>>(      \
      idx, vals, x, out, nb, K, KB, ks, ldx, s.tpr_log2)
  if (unit) {
    if (cpb == 16) FS_SMEM_NARROW(true, 16);
    else if (cpb == 8) FS_SMEM_NARROW(true, 8);
    else FS_SMEM_NARROW(true, 4);
  } else {
    if (cpb == 16) FS_SMEM_NARROW(false, 16);
    else if (cpb == 8) FS_SMEM_NARROW(false, 8);
    else FS_SMEM_NARROW(false, 4);
  }
#undef FS_SMEM_NARROW
  return 0;
}

template <int V>
int launch_bucket(const int32_t* idx, const float* vals, const float* x,
                  float* out, int nb, int K, int KB, int full, int unit,
                  int packed, int ldx, const LaneSplit& s, cudaStream_t st) {
  if (ldx <= NARROW_MAX_LANES && KB <= 4 * NARROW_SLOTS) {  // a chunk fits a step
    return launch_narrow<V>(idx, vals, x, out, nb, K, KB, full, unit, packed,
                            ldx, s, st);
  }
  const int rows_per_block = ELL_THREADS >> s.tpr_log2;
  dim3 grid((nb + rows_per_block - 1) / rows_per_block, s.n_col_blocks);
  if (unit && packed) {
    ell_bucket_kernel<V, true, true><<<grid, ELL_THREADS, 0, st>>>(
        idx, vals, x, out, nb, K, KB, full, ldx, s.tpr_log2);
  } else if (unit) {
    ell_bucket_kernel<V, true, false><<<grid, ELL_THREADS, 0, st>>>(
        idx, vals, x, out, nb, K, KB, full, ldx, s.tpr_log2);
  } else if (!packed) {
    ell_bucket_kernel<V, false, false><<<grid, ELL_THREADS, 0, st>>>(
        idx, vals, x, out, nb, K, KB, full, ldx, s.tpr_log2);
  } else {
    return (int)cudaErrorInvalidValue;  // packed pairs are unit-only
  }
  return 0;
}

}  // namespace

extern "C" {

// idx: cols int32 (nb, K), or packed pairs (nb, K/2) when packed = 1;
// vals: f32 (nb, K), unused (may be null) when unit = 1; x: f32 (x_rows,
// ldx); out: f32 (nb, ldx). KB divides K; full = 1 needs KB == K.
int fs_ell_bucket(const int32_t* idx, const float* vals, const float* x,
                  float* out, int nb, int K, int KB, int full, int unit,
                  int packed, int ldx, void* stream) {
  if (nb > 0 && ldx > 0 && K > 0) {
    if (KB <= 0 || K % KB || (full && KB != K) || (packed && K % 2)) {
      return (int)cudaErrorInvalidValue;
    }
    const LaneSplit s = lane_split(x, out, ldx);
    const cudaStream_t st = (cudaStream_t)stream;
    const int rc = s.vec4
        ? launch_bucket<4>(idx, vals, x, out, nb, K, KB, full, unit, packed, ldx, s, st)
        : launch_bucket<1>(idx, vals, x, out, nb, K, KB, full, unit, packed, ldx, s, st);
    if (rc) return rc;
  }
  return (int)cudaGetLastError();
}

// words: the parts' packed pairs concatenated row-major; row0 (n_parts+1),
// k2 and wbase (n_parts) are HOST arrays, copied into the launch's grid
// constant; out: f32 (row0[n_parts], ldx), rows in part order.
int fs_ell_sweep(const int32_t* words, const float* x, float* out,
                 const int32_t* row0, const int32_t* k2, const int32_t* wbase,
                 int n_parts, int ldx, void* stream) {
  if (n_parts <= 0 || n_parts > SWEEP_MAX_PARTS) {
    return (int)cudaErrorInvalidValue;
  }
  SweepParts parts;
  parts.n = n_parts;
  for (int p = 0; p < n_parts; ++p) {
    parts.row0[p] = row0[p];
    parts.k2[p] = k2[p];
    parts.wbase[p] = wbase[p];
  }
  parts.row0[n_parts] = row0[n_parts];
  const int total = row0[n_parts];
  if (total > 0 && ldx > 0) {
    const LaneSplit s = lane_split(x, out, ldx);
    const int rows_per_block = ELL_THREADS >> s.tpr_log2;
    dim3 grid((total + rows_per_block - 1) / rows_per_block, s.n_col_blocks);
    const cudaStream_t st = (cudaStream_t)stream;
    if (s.vec4) {
      ell_sweep_kernel<4><<<grid, ELL_THREADS, 0, st>>>(words, x, out, parts, ldx,
                                                        s.tpr_log2);
    } else {
      ell_sweep_kernel<1><<<grid, ELL_THREADS, 0, st>>>(words, x, out, parts, ldx,
                                                        s.tpr_log2);
    }
  }
  return (int)cudaGetLastError();
}

// One whole bucket: idx cols int32 (nb, K); vals f32 (nb, K), unused (may
// be null) when unit = 1; x f32 (x_rows, ldx); out f32 (nb, ldx). KB
// divides K; nb is a multiple of 8.
int fs_ell_smem(const int32_t* idx, const float* vals, const float* x,
                float* out, int nb, int K, int KB, int unit, int ldx,
                void* stream) {
  if (nb > 0 && ldx > 0 && K > 0) {
    if (KB <= 0 || K % KB) return (int)cudaErrorInvalidValue;
    const LaneSplit s = lane_split(x, out, ldx);
    const cudaStream_t st = (cudaStream_t)stream;
    if (ldx <= NARROW_MAX_LANES) {
      const int rc = s.vec4
          ? launch_smem_narrow<4>(idx, vals, x, out, nb, K, KB, unit, ldx, s, st)
          : launch_smem_narrow<1>(idx, vals, x, out, nb, K, KB, unit, ldx, s, st);
      return rc ? rc : (int)cudaGetLastError();
    }
    const int rows_per_block = ELL_THREADS >> s.tpr_log2;
    // slice: the most whole chunks whose rows (stride ks + 1) fit the stage
    const int ks = ((SMEM_STAGE_WORDS / rows_per_block - 1) / KB) * KB;
    if (ks <= 0) return (int)cudaErrorInvalidValue;
    dim3 grid((nb + rows_per_block - 1) / rows_per_block, s.n_col_blocks);
    if (s.vec4 && unit) {
      ell_smem_kernel<4, true><<<grid, ELL_THREADS, 0, st>>>(
          idx, vals, x, out, nb, K, KB, ks, ldx, s.tpr_log2);
    } else if (s.vec4) {
      ell_smem_kernel<4, false><<<grid, ELL_THREADS, 0, st>>>(
          idx, vals, x, out, nb, K, KB, ks, ldx, s.tpr_log2);
    } else if (unit) {
      ell_smem_kernel<1, true><<<grid, ELL_THREADS, 0, st>>>(
          idx, vals, x, out, nb, K, KB, ks, ldx, s.tpr_log2);
    } else {
      ell_smem_kernel<1, false><<<grid, ELL_THREADS, 0, st>>>(
          idx, vals, x, out, nb, K, KB, ks, ldx, s.tpr_log2);
    }
  }
  return (int)cudaGetLastError();
}

// tiles: n_tiles EllTile records (device); x (x_rows, ldx), every part's X
// panel at its tile's x_row0; out (slots, ldx), each tile's rows at its
// out_row; x, out and the valued tiles' values f32, or f64 when f64 = 1.
// idx_cap (words), val_cap and prod_cap (elements of the value type; all
// multiples of 4) hold the largest staged tile's spans and products
// (val_cap 0 when unit = 1). ldx <= NARROW_MAX_LANES.
int fs_ell_table(const void* tiles, int n_tiles, const void* x, void* out,
                 int ldx, int unit, int f64, int idx_cap, int val_cap,
                 int prod_cap, void* stream) {
  if (n_tiles <= 0 || ldx <= 0) return (int)cudaGetLastError();
  if (ldx > NARROW_MAX_LANES || (idx_cap | val_cap | prod_cap) & 3) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t esize = f64 ? 8 : 4;
  const size_t smem = 16 + 4 * (size_t)idx_cap + esize * ((size_t)val_cap + prod_cap);
  const cudaStream_t st = (cudaStream_t)stream;
  const EllTile* t = static_cast<const EllTile*>(tiles);
  if (f64) {
    // V = 2 (one 16-byte double2) at even widths on 16-byte buffers
    const bool vec2 = ldx % 2 == 0 && (uintptr_t)x % 16 == 0 &&
                      (uintptr_t)out % 16 == 0;
    const int nvec = vec2 ? ldx / 2 : ldx;
    int tq_log2 = 0;
    while ((1 << tq_log2) < nvec) ++tq_log2;
#define FS_TABLE64(V, U) \
  launch_table<double, V, U>(t, n_tiles, x, out, ldx, idx_cap, val_cap, smem, tq_log2, st)
    if (vec2) return unit ? FS_TABLE64(2, true) : FS_TABLE64(2, false);
    return unit ? FS_TABLE64(1, true) : FS_TABLE64(1, false);
#undef FS_TABLE64
  }
  const LaneSplit s = lane_split(x, out, ldx);
#define FS_TABLE(V, U) \
  launch_table<float, V, U>(t, n_tiles, x, out, ldx, idx_cap, val_cap, smem, s.tpr_log2, st)
  if (s.vec4) return unit ? FS_TABLE(4, true) : FS_TABLE(4, false);
  return unit ? FS_TABLE(1, true) : FS_TABLE(1, false);
#undef FS_TABLE
}

}  // extern "C"
