// Hand-written Hopper (sm_90a) kernels for the tile-bucket and class-panel
// BSR layouts: the CUDA counterparts of bucket_spmm (#5), panel_spmm (#6)
// and bucket_spmv (#8) in fastsparse/ops/pallas/bsr_spmm.py.
//
//   fs_bucket_spmm  Y[i·TM + r, c] = Σ_t Σ_k tile[i,t,r,k] · X[slab[i,t]·TK + k, c]
//                   planes = 3 ("planes_n"): X holds three bf16 planes per
//                   NB-wide block, [x0_j | x1_j | x2_j]; each plane is
//                   summed over all the strip's tiles on its own and the
//                   three are added after the tile loop, (p0 + p1) + p2.
//                   planes = 1: one sum (bf16 tiles × bf16 narrow planes,
//                   f32 tiles × f32 X, or bf16 tiles × f32 X).
//   fs_panel_spmm   Y[i·TM + r, c] = Σ_k panel[i,r,k] · X[row_base + start[i]·TK + k, c]
//                   split = 1 (fold "f32"): each f32 X value is cut into
//                   three bf16 planes by round-to-nearest casts in the
//                   kernel, x0 = bf16(x), x1 = bf16(x - x0),
//                   x2 = bf16(x - x0 - x1), and the three dots are added
//                   (d0 + d1) + d2. split = 0: one dot.
//   fs_bucket_spmv  y[i, r] = Σ_t Σ_c tile[i,t,r,c] · x[slab[i,t], c]
//
// The TPU kernels run the tile axis as an in-order ("arbitrary") grid axis
// that accumulates into the output block. Here one CTA owns one
// (strip slot, 128-column block) and loops over the strip's tiles (or the
// panel's k range) itself, so every output element is written once, with
// no atomics. bucket_spmm splits the tile loop over four 128-thread groups
// (tiles t ≡ g mod 4, each group with its own barrier) and adds the four
// group sums in group order at the end: a bucket of a few strips gives
// few CTAs, and one serial tile chain each left the card idle. Each thread
// owns one output column and keeps TM_CHUNK rows × planes accumulators in
// registers; the current tile rows are staged in shared memory as f32, at
// most K_CHUNK columns at a time (so any tile_k runs within 48 KB), and
// read as broadcasts. The k loops are unrolled so
// that several X loads are in flight per thread: a bucket of a few strips
// gives few CTAs, and each k step waits on an L2 load otherwise. bucket_spmv gives one warp
// to each (strip slot, row): lanes stride the tile's columns, and a
// shuffle sum reduces the 32 lane sums.
//
// Bound on this card: bf16·bf16 products and int8·bf16 products are exact
// in f32, so fp32 parity needs no tensor-core emulation; these first
// versions run the multiply-adds on the f32 pipes (scalar FMA, 67 TFLOP/s).
// At the main path's shapes that makes #5 and #6 bound by operations (per
// tile 2·TM·TK·planes·N of them against 2·TM·TK + TK·3·N bytes), #8 by the
// tile bytes it streams once. X is read once per tile, through L2 (the
// segments' X panels are a few MB). A bf16 mma.sync/wgmma pipeline is a
// later PR (PERF.md).
//
// Summation order: f32 in k order within a tile and tile order within a
// group (bucket_spmm) or a strip, fused multiply-adds (exact products for
// the bf16 modes). It is
// not the MXU's order, so the bar against the plain versions is
// max|d|/max|ref| <= 1e-6, not bit-exactness.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COLS = 128;     // output columns per CTA (one per thread)
constexpr int TM_CHUNK = 8;   // output rows per pass over the tiles
// tile (or panel) columns staged in shared memory at a time: any tile_k
// runs in chunks, and four groups' chunks stay within 48 KB
constexpr int K_CHUNK = 256;

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float ld(const int8_t* p, size_t i) {
  return (float)p[i];
}

// ---------------------------------------------------------------- #5
constexpr int GROUPS = 4;  // tile-loop thread groups of a bucket_spmm CTA

// Barrier of one 128-thread group (ids 1..GROUPS; 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(COLS) : "memory");
}

template <typename TT, typename XT, int PLANES>
__global__ void __launch_bounds__(COLS * GROUPS)
bucket_spmm_kernel(const int* __restrict__ slab_ids,  // [ns, T]
                   const TT* __restrict__ tiles,      // [ns, T, TM, TK]
                   const XT* __restrict__ x,          // [K, x_cols]
                   float* __restrict__ out,           // [ns·TM, Npad]
                   int T, int TM, int TK, int x_cols, int Npad, int NB,
                   int ncb) {
  // per group a [TM_CHUNK][min(TK, K_CHUNK)] tile buffer; reused for the
  // group sums
  extern __shared__ float smem[];
  const int c = threadIdx.x % COLS;
  const int g = threadIdx.x / COLS;
  float* tile_s = smem + (size_t)g * TM_CHUNK * min(TK, K_CHUNK);
  const int i = blockIdx.x / ncb;
  const int col = (blockIdx.x - i * ncb) * COLS + c;
  const bool live = col < Npad;
  const int j = col / NB;
  size_t xcol[PLANES];
#pragma unroll
  for (int p = 0; p < PLANES; ++p)
    xcol[p] = (size_t)(j * PLANES + p) * NB + (col - j * NB);

  for (int r0 = 0; r0 < TM; r0 += TM_CHUNK) {
    const int nr = min(TM_CHUNK, TM - r0);
    float acc[PLANES][TM_CHUNK];
#pragma unroll
    for (int p = 0; p < PLANES; ++p)
#pragma unroll
      for (int r = 0; r < TM_CHUNK; ++r) acc[p][r] = 0.f;
    for (int t = g; t < T; t += GROUPS) {  // group g: tiles t ≡ g mod 4
      const size_t tile0 = ((size_t)i * T + t) * TM * TK + (size_t)r0 * TK;
      const size_t xrow0 = (size_t)slab_ids[(size_t)i * T + t] * TK;
      // the tile's columns in chunks of at most K_CHUNK, in k order
      for (int k0 = 0; k0 < TK; k0 += K_CHUNK) {
        const int kc = min(K_CHUNK, TK - k0);
        group_sync(g);  // the group's previous tile rows are consumed
        for (int q = c; q < TM_CHUNK * kc; q += COLS) {
          const int r = q / kc;
          tile_s[q] =
              r < nr ? ld(tiles, tile0 + (size_t)r * TK + k0 + (q - r * kc)) : 0.f;
        }
        group_sync(g);
        if (!live) continue;
#pragma unroll 8
        for (int k = 0; k < kc; ++k) {
          const size_t xr = (xrow0 + k0 + k) * x_cols;
          float xv[PLANES];
#pragma unroll
          for (int p = 0; p < PLANES; ++p) xv[p] = ld(x, xr + xcol[p]);
#pragma unroll
          for (int r = 0; r < TM_CHUNK; ++r) {
            const float a = tile_s[r * kc + k];
#pragma unroll
            for (int p = 0; p < PLANES; ++p)
              acc[p][r] = __fmaf_rn(a, xv[p], acc[p][r]);
          }
        }
      }
    }
    // group 0 adds the other groups' sums in group order, plane by plane
    __syncthreads();
#pragma unroll
    for (int p = 0; p < PLANES; ++p) {
      if (g > 0) {
#pragma unroll
        for (int r = 0; r < TM_CHUNK; ++r)
          smem[((g - 1) * TM_CHUNK + r) * COLS + c] = acc[p][r];
      }
      __syncthreads();
      if (g == 0) {
#pragma unroll
        for (int r = 0; r < TM_CHUNK; ++r)
          for (int h = 1; h < GROUPS; ++h)
            acc[p][r] = __fadd_rn(acc[p][r],
                                  smem[((h - 1) * TM_CHUNK + r) * COLS + c]);
      }
      __syncthreads();
    }
    if (g == 0 && live) {
      for (int r = 0; r < nr; ++r) {
        float v = acc[0][r];
        if constexpr (PLANES == 3)
          v = __fadd_rn(__fadd_rn(acc[0][r], acc[1][r]), acc[2][r]);
        out[((size_t)i * TM + r0 + r) * Npad + col] = v;
      }
    }
  }
}

// ---------------------------------------------------------------- #6
template <typename PT, typename XT, bool SPLIT>
__global__ void __launch_bounds__(COLS)
panel_spmm_kernel(const int* __restrict__ start,   // [ns]
                  const PT* __restrict__ panels,   // [ns, TM, PK]
                  const XT* __restrict__ x,        // [K, x_cols]
                  float* __restrict__ out,         // [ns·TM, x_cols]
                  int TM, int TK, int PK, int x_cols, int row_base,
                  int ncb) {
  extern __shared__ float pan_s[];  // [TM_CHUNK][min(TK, K_CHUNK)]
  constexpr int NP = SPLIT ? 3 : 1;
  const int kstep = min(TK, K_CHUNK);
  const int i = blockIdx.x / ncb;
  const int col = (blockIdx.x - i * ncb) * COLS + threadIdx.x;
  const bool live = col < x_cols;
  const size_t xrow0 = (size_t)row_base + (size_t)start[i] * TK;

  for (int r0 = 0; r0 < TM; r0 += TM_CHUNK) {
    const int nr = min(TM_CHUNK, TM - r0);
    float acc[NP][TM_CHUNK];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int r = 0; r < TM_CHUNK; ++r) acc[p][r] = 0.f;
    for (int k0 = 0; k0 < PK; k0 += kstep) {
      const int kc = min(kstep, PK - k0);
      __syncthreads();
      for (int q = threadIdx.x; q < TM_CHUNK * kc; q += COLS) {
        const int r = q / kc;
        pan_s[q] = r < nr ? ld(panels, ((size_t)i * TM + r0 + r) * PK + k0 +
                                           (q - r * kc))
                          : 0.f;
      }
      __syncthreads();
      if (!live) continue;
#pragma unroll 8
      for (int k = 0; k < kc; ++k) {
        const float xf = ld(x, (xrow0 + k0 + k) * x_cols + col);
        float xv[NP];
        if constexpr (SPLIT) {
          const __nv_bfloat16 b0 = __float2bfloat16_rn(xf);
          const float r1 = __fsub_rn(xf, __bfloat162float(b0));
          const __nv_bfloat16 b1 = __float2bfloat16_rn(r1);
          const float r2 = __fsub_rn(r1, __bfloat162float(b1));
          xv[0] = __bfloat162float(b0);
          xv[1] = __bfloat162float(b1);
          xv[2] = __bfloat162float(__float2bfloat16_rn(r2));
        } else {
          xv[0] = xf;
        }
#pragma unroll
        for (int r = 0; r < TM_CHUNK; ++r) {
          const float a = pan_s[r * kc + k];
#pragma unroll
          for (int p = 0; p < NP; ++p)
            acc[p][r] = __fmaf_rn(a, xv[p], acc[p][r]);
        }
      }
    }
    if (live) {
      for (int r = 0; r < nr; ++r) {
        float v = acc[0][r];
        if constexpr (SPLIT)
          v = __fadd_rn(__fadd_rn(acc[0][r], acc[1][r]), acc[2][r]);
        out[((size_t)i * TM + r0 + r) * x_cols + col] = v;
      }
    }
  }
}

// ---------------------------------------------------------------- #8
template <typename TT>
__global__ void __launch_bounds__(256)
bucket_spmv_kernel(const int* __restrict__ slab_ids,  // [ns, T]
                   const TT* __restrict__ tiles,      // [ns, T, TM, TK]
                   const float* __restrict__ x,       // [n_slabs, TK]
                   float* __restrict__ out,           // [ns, TM]
                   int T, int TM, int TK, int nrb) {
  const int i = blockIdx.x / nrb;
  const int r = (blockIdx.x - i * nrb) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= TM) return;  // whole warps leave: no barrier follows
  float acc = 0.f;
  for (int t = 0; t < T; ++t) {
    const size_t slab = (size_t)slab_ids[(size_t)i * T + t];
    const size_t row = (((size_t)i * T + t) * TM + r) * TK;
#pragma unroll 4
    for (int c = lane; c < TK; c += 32)
      acc = __fmaf_rn(ld(tiles, row + c), x[slab * TK + c], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (lane == 0) out[(size_t)i * TM + r] = acc;
}

template <typename TT, typename XT, int PLANES>
void launch_bucket(const int* slab, const void* tiles, const void* x,
                   float* out, int ns, int T, int TM, int TK, int x_cols,
                   int Npad, int NB, cudaStream_t st) {
  const int ncb = (Npad + COLS - 1) / COLS;
  const int tile_floats = GROUPS * TM_CHUNK * (TK < K_CHUNK ? TK : K_CHUNK);
  const int sum_floats = (GROUPS - 1) * TM_CHUNK * COLS;
  const size_t smem =
      sizeof(float) * (tile_floats > sum_floats ? tile_floats : sum_floats);
  bucket_spmm_kernel<TT, XT, PLANES>
      <<<(unsigned int)ns * ncb, COLS * GROUPS, smem, st>>>(
          slab, (const TT*)tiles, (const XT*)x, out, T, TM, TK, x_cols, Npad,
          NB, ncb);
}

template <typename PT, typename XT, bool SPLIT>
void launch_panel(const int* start, const void* panels, const void* x,
                  float* out, int ns, int TM, int TK, int PK, int x_cols,
                  int row_base, cudaStream_t st) {
  const int ncb = (x_cols + COLS - 1) / COLS;
  panel_spmm_kernel<PT, XT, SPLIT>
      <<<(unsigned int)ns * ncb, COLS,
         TM_CHUNK * (TK < K_CHUNK ? TK : K_CHUNK) * sizeof(float), st>>>(
          start, (const PT*)panels, (const XT*)x, out, TM, TK, PK, x_cols,
          row_base, ncb);
}

}  // namespace

extern "C" {

// dtype codes: 0 int8, 1 bf16, 2 f32. Returns cudaGetLastError(); an
// unsupported combination returns cudaErrorInvalidValue.
int fs_bucket_spmm(const int* slab_ids, const void* tiles, const void* x,
                   float* out, int ns, int T, int TM, int TK, int x_cols,
                   int Npad, int NB, int planes, int tile_dt, int x_dt,
                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (tile_dt == 1 && x_dt == 1 && planes == 3) {
    launch_bucket<__nv_bfloat16, __nv_bfloat16, 3>(
        slab_ids, tiles, x, out, ns, T, TM, TK, x_cols, Npad, NB, st);
  } else if (tile_dt == 1 && x_dt == 1 && planes == 1) {
    launch_bucket<__nv_bfloat16, __nv_bfloat16, 1>(
        slab_ids, tiles, x, out, ns, T, TM, TK, x_cols, Npad, NB, st);
  } else if (tile_dt == 2 && x_dt == 2 && planes == 1) {
    launch_bucket<float, float, 1>(slab_ids, tiles, x, out, ns, T, TM, TK,
                                   x_cols, Npad, NB, st);
  } else if (tile_dt == 1 && x_dt == 2 && planes == 1) {
    launch_bucket<__nv_bfloat16, float, 1>(slab_ids, tiles, x, out, ns, T, TM,
                                           TK, x_cols, Npad, NB, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int fs_panel_spmm(const int* start, const void* panels, const void* x,
                  float* out, int ns, int TM, int TK, int PK, int x_cols,
                  int row_base, int panel_dt, int x_dt, int split,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (split && x_dt == 2 && panel_dt == 0) {
    launch_panel<int8_t, float, true>(start, panels, x, out, ns, TM, TK, PK,
                                      x_cols, row_base, st);
  } else if (split && x_dt == 2 && panel_dt == 1) {
    launch_panel<__nv_bfloat16, float, true>(start, panels, x, out, ns, TM,
                                             TK, PK, x_cols, row_base, st);
  } else if (!split && x_dt == 1 && panel_dt == 0) {
    launch_panel<int8_t, __nv_bfloat16, false>(start, panels, x, out, ns, TM,
                                               TK, PK, x_cols, row_base, st);
  } else if (!split && x_dt == 1 && panel_dt == 1) {
    launch_panel<__nv_bfloat16, __nv_bfloat16, false>(
        start, panels, x, out, ns, TM, TK, PK, x_cols, row_base, st);
  } else if (!split && x_dt == 2 && panel_dt == 2) {
    launch_panel<float, float, false>(start, panels, x, out, ns, TM, TK, PK,
                                      x_cols, row_base, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int fs_bucket_spmv(const int* slab_ids, const void* tiles, const float* x,
                   float* out, int ns, int T, int TM, int TK, int tile_dt,
                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nrb = (TM + 7) / 8;
  const unsigned int grid = (unsigned int)ns * nrb;
  if (tile_dt == 1) {
    bucket_spmv_kernel<__nv_bfloat16><<<grid, 256, 0, st>>>(
        slab_ids, (const __nv_bfloat16*)tiles, x, out, T, TM, TK, nrb);
  } else if (tile_dt == 2) {
    bucket_spmv_kernel<float><<<grid, 256, 0, st>>>(
        slab_ids, (const float*)tiles, x, out, T, TM, TK, nrb);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
