// Hand-written Hopper (sm_90a) kernel that applies an assembly plan.
//
//   fs_plan_sum   Y[r] = P[src[ptr[r]]] + P[src[ptr[r] + 1]] + ...
//                 (+ 0.0f for a row of 1..n_levels-1 sources)
//
// It replaces no Pallas TPU kernel: the reference leaves its plans to XLA
// (fastsparse/ops/assemble.py), and the port ran them as torch ops: per
// multiplicity class an index cast, w row gathers and w - 1 adds, then a
// zero row, a concatenation and a row gather into matrix order, ~1,000
// short ops for one application of a scale-free graph's plan. This kernel
// walks the plan's row-ordered schedule (ops/assemble.py, plan_schedule)
// instead and writes each output row once, in matrix order: no scatter,
// no atomics, no intermediate panels.
//
// Bit-equal to the torch ops: a row's sources are added strictly in
// schedule order (slot 0 + slot 1 + ...), one round-to-nearest f32 add
// each (__fadd_rn, and the library builds with --fmad=false); a row of
// one source is its copy (-0.0 kept), an empty row +0.0, and a row that a
// row_srcs plan follows with sentinel levels gets one last + 0.0f, as the
// zero row's adds give (-0.0 becomes +0.0; a second + 0.0 changes nothing).
//
// Bound on this card: device-memory bytes, each real source row read once
// and each output row written once (f32 rows of L lanes), plus 4 B of
// index a source and 4 B a row. No arithmetic to speak of.
//
// Design: the kernel adapts to the row width L it is given and to each
// row's source count, and to nothing else. A row's L lanes are split over
// TPR = min(32, next_pow2(L / V)) threads, each owning V consecutive
// lanes (V = 4, one 16-byte load, when L is a multiple of 4 and both
// buffers are 16-byte aligned; else V = 1): at L >= 128 a warp per row,
// looping over the row; at 4 <= L < 128 several rows share a warp; below
// 4 (SpMV) scalar lanes, a row to a thread. A thread loads up to AHEAD
// sources' vectors before adding them in order, so a long row (a hub's
// 20-75 sources) keeps AHEAD loads in flight rather than one.
//
// An f64 mode (f64 = 1) sums f64 rows the same way, one __dadd_rn each,
// 16-byte double2 vectors (V = 2) at even L: it sums the column segments'
// parts of a float64 product (ops/ell_ops.py, _table_product), each row's
// in segment order, where the torch ops would add the same rows alike.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int AHEAD = 8;

__device__ __forceinline__ float vadd(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ double vadd(double a, double b) {
  return __dadd_rn(a, b);
}

__device__ __forceinline__ double2 vadd(double2 a, double2 b) {
  return make_double2(__dadd_rn(a.x, b.x), __dadd_rn(a.y, b.y));
}

template <typename T>
__device__ __forceinline__ T vzero();

template <>
__device__ __forceinline__ float vzero<float>() {
  return 0.0f;
}

template <>
__device__ __forceinline__ float4 vzero<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

template <>
__device__ __forceinline__ double vzero<double>() {
  return 0.0;
}

template <>
__device__ __forceinline__ double2 vzero<double2>() {
  return make_double2(0.0, 0.0);
}

// T: float4 (V = 4) or float (V = 1); f64: double2 (V = 2) or double;
// lv = L / V vectors a row.
template <typename T>
__global__ void __launch_bounds__(THREADS)
plan_sum_kernel(const int32_t* __restrict__ ptr,
                const int32_t* __restrict__ src,
                const T* __restrict__ parts, T* __restrict__ y, int nrow,
                int lv, int tpr_log2, int n_levels) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long r = t >> tpr_log2;
  if (r >= nrow) return;
  const int tpr = 1 << tpr_log2;
  const int beg = ptr[r];
  const int cnt = ptr[r + 1] - beg;
  const bool pad = cnt > 0 && cnt < n_levels;
  T* yr = y + r * lv;
  for (int c = (int)(t & (tpr - 1)); c < lv; c += tpr) {
    T acc = vzero<T>();
    for (int j0 = 0; j0 < cnt; j0 += AHEAD) {
      T v[AHEAD];
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        if (j0 + u < cnt) {
          v[u] = __ldg(parts + (long long)__ldg(src + beg + j0 + u) * lv + c);
        }
      }
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        if (j0 + u < cnt) acc = (j0 + u == 0) ? v[u] : vadd(acc, v[u]);
      }
    }
    if (pad) acc = vadd(acc, vzero<T>());
    yr[c] = acc;
  }
}

}  // namespace

extern "C" {

// ptr: int32 (nrow + 1); src: int32 (ptr[nrow]) rows of parts; parts: f32
// (n, L), f64 when f64 = 1; y: (nrow, L), of the same type.
int fs_plan_sum(const int32_t* ptr, const int32_t* src, const void* parts,
                void* y, int nrow, int L, int n_levels, int f64, void* stream) {
  if (nrow > 0 && L > 0) {
    const int vw = f64 ? 2 : 4;  // elements a 16-byte vector
    const bool vec = L % vw == 0 && (uintptr_t)parts % 16 == 0 &&
                     (uintptr_t)y % 16 == 0;
    const int lv = vec ? L / vw : L;
    int tpr_log2 = 0;
    while ((1 << tpr_log2) < lv && tpr_log2 < 5) ++tpr_log2;
    const long long grid =
        (((long long)nrow << tpr_log2) + THREADS - 1) / THREADS;
    if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
#define FS_PLAN(T)                                                         \
  plan_sum_kernel<T><<<(unsigned int)grid, THREADS, 0, st>>>(              \
      ptr, src, static_cast<const T*>(parts), static_cast<T*>(y), nrow, lv, \
      tpr_log2, n_levels)
    if (f64) {
      if (vec) {
        FS_PLAN(double2);
      } else {
        FS_PLAN(double);
      }
    } else if (vec) {
      FS_PLAN(float4);
    } else {
      FS_PLAN(float);
    }
#undef FS_PLAN
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
