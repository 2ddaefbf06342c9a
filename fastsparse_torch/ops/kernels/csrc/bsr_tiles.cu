// Hand-written Hopper (sm_90a) kernels for the tile-bucket and class-panel
// BSR layouts: the CUDA counterparts of bucket_spmm (#5), panel_spmm (#6)
// and bucket_spmv (#8) in fastsparse/ops/pallas/bsr_spmm.py.
//
//   fs_bucket_spmm  Y[i·TM + r, c] = Σ_t Σ_k tile[i,t,r,k] · X[slab[i,t]·TK + k, c]
//   fs_panel_spmm   Y[i·TM + r, c] = Σ_k panel[i,r,k] · X[row_base + start[i]·TK + k, c]
//   fs_bucket_spmv  y[i, r] = Σ_t Σ_c tile[i,t,r,c] · x[slab[i,t], c]
//
// #5 and #6 have two bodies, and each dtype combination goes to exactly one.
//
// The tensor-core body (tile_mma_kernel) takes the exact-bf16 modes, the
// ones every BASELINE path runs:
//   * bucket_spmm planes = 3 ("planes_n"): bf16 tiles × bf16 X holding three
//     planes per NB-wide block, [x0_j | x1_j | x2_j];
//   * bucket_spmm planes = 1 with bf16 X (the narrow plane packing);
//   * panel_spmm split = 1 (fold "f32"): int8 or bf16 panels × f32 X, each X
//     value cut into three bf16 planes as it is loaded, by the round-to-
//     nearest casts x0 = bf16(x), x1 = bf16(x - x0), x2 = bf16(x - x0 - x1);
//   * panel_spmm narrow: int8 or bf16 panels × bf16 X.
// A product of two bf16 values (an int8 value is exact in bf16) is exact in
// f32, so bf16 MMAs with f32 sums lose nothing a scalar f32 FMA keeps. The
// scalar body (bucket_scalar_kernel, panel_scalar_kernel) takes the f32-
// valued modes: f32 tiles or panels × f32 X and bf16 tiles × f32 X. No
// tensor-core type holds an f32 product exactly (TF32 keeps 10 bits).
//
// Bound on this card. Per tile a body reads the tile (2 KB at 8 × 128 bf16)
// and its slab's TK rows of X at full width (planes × N lanes: 96 KB at
// N = 128 in planes_n). The X panels of a segment (a few MB) stay in the
// 50 MB L2, so the X reads set the pace, not HBM and not the arithmetic:
// the bf16 work of #5 on the ECFP backward segment is a few µs on the
// tensor cores (it was ~70 µs of scalar FMAs), and reading only the live
// columns' X rows halved its device time on the H100 (PERF.md). The MMA
// body is built around those reads:
//   * Compaction. A warp ORs a tile chunk's 8 rows over its 128 columns,
//     ballots the column mask, and gathers only the live columns' X rows and
//     tile columns, zero-padded to a multiple of 16; a chunk with no live
//     column (a padding tile) reads no X at all. A dropped column is zero in
//     every row of the chunk, so only exact zeros leave the sum (finite X).
//   * X rows go from L2 straight to registers, 16 bytes (8 lanes) a thread,
//     8 threads per 128-byte line, with no shared-memory round trip: the
//     MMA's M axis is permuted so that a thread's 8 lanes are its rows in
//     four m16 fragments, and its A fragments come from two loaded rows by
//     byte permutes. The next chunk's tile rows are loaded while the
//     current chunk's X rows are in flight.
//   * A CTA's four warps split one strip's chunk loop (S = 4 or 2 ways) or
//     take four strips (S = 1), so a bucket of few strips still puts many
//     warps on the card; the splits' sums are added in split order.
//
// MMA roles: mma.sync m16n8k16 bf16 -> f32 with M = 16 X lanes, N = 8 tile
// rows, K = 16 live tile columns, i.e. Yᵀ = Xᵀ · tileᵀ. The row-major tile
// is the column layout B wants: a thread's B fragment is four consecutive
// compacted columns of one tile row (one 8-byte shared-memory read), which
// fixes the K permutation its A fragment follows. A warp owns 64 output
// lanes × 8 tile rows. tile_m past 8, or not a multiple of 8, runs 8-row
// chunks; rows past TM are zero in B and not stored.
//
// Summation: each MMA adds 16 exact products in the tensor core's own order
// and rounding, from C = 0; every add across MMAs, splits and planes is an
// IEEE round-to-nearest __fadd_rn, so a long strip's error grows with its
// k16 steps like a scalar sum's, never with the tensor core's truncation.
// Per plane the order is compacted-column order within a chunk, chunk order
// within a split, then the splits in order; the planes fold after the loop,
// (p0 + p1) + p2. The scalar body sums f32 in k order within a tile and tile
// order within a thread group (bucket) or the panel, fused multiply-adds.
// Neither is the MXU's order: the bar against the plain versions is
// max|d|/max|ref| <= 1e-6, not bit-exactness.
//
// bucket_spmv streams the tiles once and is bound by their bytes (11.8 MB
// on the ECFP backward segment, 0.0036 ms at 3.35 TB/s), but its launches
// are short (a strip holds 1-32 tiles of 2 KB, in L2 when the product
// repeats), so round trips and the work around them set its time, not
// the bytes. A warp owns a block of a strip's rows: a tile row is LPR
// lanes' 16-byte chunks (LPR = 16 at tile_k 128 bf16, so a warp load is
// two 256-byte rows), and a lane loads up to 4 tiles' chunks and their x
// chunks before its FMAs; a strip of more tiles is split over 2 or 4
// warps of the CTA (contiguous tile ranges). Measured on the H100
// (PERF.md): a warp per whole strip (each x chunk read once for its 8
// rows) or 16 chunks in flight per lane ran slower than this, by the
// registers and predicated slots they cost; the x re-reads stay in L2.
// Order: a lane sums its chunks by fused multiply-adds, column order
// within a chunk, then its column chunks, then the tiles in order; a
// shuffle tree adds a row's lanes; the splits add in split order. Not the
// MXU's order: held to max|d|/max|ref| <= 1e-6 against the f64 plain
// version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// ------------------------------------------------------ tensor-core body
constexpr int MW = 4;               // warps per CTA
constexpr int WL = 64;              // output lanes per warp (8 per thread)
constexpr int KC = 128;             // tile columns per chunk (4 per thread)
constexpr int CT_STRIDE = KC + 16;  // compacted row stride in halves: the
                                    // B-fragment reads are conflict-free
enum XMode { X_BF16 = 0, X_PLANES = 1, X_SPLIT = 2 };
// a shape the MMA body does not take (cudaError_t values are >= 0)
constexpr int FS_SHAPE_REFUSED = -1;

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Four consecutive columns of one tile row as bf16 bit patterns.
__device__ __forceinline__ uint2 cols4(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ uint2 cols4(const int8_t* p) {
  const int v = __ldg(reinterpret_cast<const int*>(p));
  return make_uint2(
      bits(__floats2bfloat162_rn((float)(int8_t)v, (float)(int8_t)(v >> 8))),
      bits(__floats2bfloat162_rn((float)(int8_t)(v >> 16),
                                 (float)(int8_t)(v >> 24))));
}

// Three bf16 planes of two f32 values, as bsr_tiles._split_rn cuts them.
__device__ __forceinline__ void split2(float a, float b, uint32_t& w0,
                                       uint32_t& w1, uint32_t& w2) {
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(a, b);
  const float ra = __fsub_rn(a, __low2float(h0));
  const float rb = __fsub_rn(b, __high2float(h0));
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(ra, rb);
  w0 = bits(h0);
  w1 = bits(h1);
  w2 = bits(__floats2bfloat162_rn(__fsub_rn(ra, __low2float(h1)),
                                  __fsub_rn(rb, __high2float(h1))));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
}

// One chunk of a strip: the tile columns [k0, k0 + KC) of item t.
struct Chunk {
  uint2 v[8];         // this thread's 4 columns of the 8 rows
  long long xrow0;    // X row of the chunk's first column
};

template <typename TT>
__device__ __forceinline__ void load_chunk(
    Chunk& c, const int* __restrict__ idx, const TT* __restrict__ tiles,
    int i, int u, int nkc, int T, int TM, int KW, int TK, int row_base,
    int r0, int lane) {
  const int t = u / nkc;
  const int k0 = (u - t * nkc) * KC;
  const size_t item = (size_t)i * T + t;
  c.xrow0 = (long long)row_base + (long long)idx[item] * TK + k0;
  const bool col_ok = k0 + 4 * lane < KW;
  const TT* p = tiles + (item * TM + r0) * KW + k0 + 4 * lane;
#pragma unroll
  for (int r = 0; r < 8; ++r)
    c.v[r] = col_ok && r0 + r < TM ? cols4(p + (size_t)r * KW)
                                   : make_uint2(0u, 0u);
}

template <typename TT, int XM>
__global__ void __launch_bounds__(MW * 32)
tile_mma_kernel(const int* __restrict__ idx,   // [ns, T] X row block per item
                const TT* __restrict__ tiles,  // [ns, T, TM, KW]
                const void* __restrict__ xv,   // [K, x_cols]
                float* __restrict__ out,       // [ns·TM, Npad]
                int ns, int T, int TM, int KW, int TK, int x_cols, int Npad,
                int NB, int row_base, int S) {
  constexpr int NP = XM == X_BF16 ? 1 : 3;  // planes summed apart
  __shared__ __align__(16) uint16_t ct_s[MW][8][CT_STRIDE];
  __shared__ __align__(16) uint8_t cc_s[MW][KC];
  __shared__ float red_s[MW][NP * 16][32];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment group: tile row, and 8 output lanes
  const int q = lane & 3;   // thread in group: 4 compacted columns
  const int i = blockIdx.x * (MW / S) + warp / S;  // strip slot
  const int s = warp % S;                          // split of its chunks
  const bool strip_live = i < ns;
  const int c0 = blockIdx.y * WL + 8 * g;  // this thread's first output lane
  const bool lanes_live = c0 < Npad;
  int xl[NP];  // X lane of plane p for output lane c0
  if constexpr (XM == X_PLANES) {
    const int j = c0 / NB;
#pragma unroll
    for (int p = 0; p < NP; ++p) xl[p] = (j * 3 + p) * NB + (c0 - j * NB);
  } else {
    xl[0] = c0;
  }
  const int nkc = (KW + KC - 1) / KC;
  const int U = T * nkc;  // chunks of a strip
  uint16_t(*ct)[CT_STRIDE] = ct_s[warp];
  uint8_t* cc = cc_s[warp];

  for (int r0 = 0; r0 < TM; r0 += 8) {
    float acc[NP][4][4];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int f = 0; f < 4; ++f)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[p][f][k] = 0.f;

    Chunk nxt;
    if (strip_live && s < U)
      load_chunk(nxt, idx, tiles, i, s, nkc, T, TM, KW, TK, row_base, r0,
                 lane);
    for (int u = s; strip_live && u < U; u += S) {
      const Chunk cur = nxt;
      if (u + S < U)
        load_chunk(nxt, idx, tiles, i, u + S, nkc, T, TM, KW, TK, row_base,
                   r0, lane);
      // live columns: nonzero in some row (bf16 ±0 are both zero)
      uint32_t ox = 0, oy = 0;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        ox |= cur.v[r].x;
        oy |= cur.v[r].y;
      }
      ox &= 0x7fff7fffu;
      oy &= 0x7fff7fffu;
      const bool nz[4] = {(ox & 0xffffu) != 0, (ox >> 16) != 0,
                          (oy & 0xffffu) != 0, (oy >> 16) != 0};
      uint32_t w[4];
      int base[4], L = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        w[b] = __ballot_sync(0xffffffffu, nz[b]);
        base[b] = L;
        L += __popc(w[b]);
      }
      if (L == 0) continue;  // warp-uniform: no X row to read
      __syncwarp();          // the previous chunk's reads of ct/cc are done
      const uint32_t below = (1u << lane) - 1u;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (!nz[b]) continue;
        const int pos = base[b] + __popc(w[b] & below);
        cc[pos] = (uint8_t)(4 * lane + b);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const uint32_t word = b < 2 ? cur.v[r].x : cur.v[r].y;
          ct[r][pos] = (uint16_t)(b & 1 ? word >> 16 : word);
        }
      }
      const int L16 = (L + 15) & ~15;
      if (L + lane < L16) {
#pragma unroll
        for (int r = 0; r < 8; ++r) ct[r][L + lane] = 0;
      }
      __syncwarp();

      // k16 steps: this thread's compacted columns j0 .. j0 + 3
      for (int j0 = 4 * q; j0 < L16; j0 += 16) {
        const uint32_t cols = *reinterpret_cast<const uint32_t*>(cc + j0);
        const uint2 bf = *reinterpret_cast<const uint2*>(&ct[g][j0]);
        uint32_t xw[NP][4][4];  // [plane][column e][lane pair f]
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = lanes_live && j0 + e < L;
          const size_t row =
              (size_t)(cur.xrow0 + ((cols >> (8 * e)) & 0xffu)) * x_cols;
          if constexpr (XM == X_SPLIT) {
            float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
            if (ok) {
              const float4* src = reinterpret_cast<const float4*>(
                  static_cast<const float*>(xv) + row + xl[0]);
              lo = __ldg(src);
              hi = __ldg(src + 1);
            }
            split2(lo.x, lo.y, xw[0][e][0], xw[1][e][0], xw[2][e][0]);
            split2(lo.z, lo.w, xw[0][e][1], xw[1][e][1], xw[2][e][1]);
            split2(hi.x, hi.y, xw[0][e][2], xw[1][e][2], xw[2][e][2]);
            split2(hi.z, hi.w, xw[0][e][3], xw[1][e][3], xw[2][e][3]);
          } else {
            const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(xv);
#pragma unroll
            for (int p = 0; p < NP; ++p) {
              uint4 t = make_uint4(0u, 0u, 0u, 0u);
              if (ok)
                t = __ldg(reinterpret_cast<const uint4*>(xb + row + xl[p]));
              xw[p][e][0] = t.x;
              xw[p][e][1] = t.y;
              xw[p][e][2] = t.z;
              xw[p][e][3] = t.w;
            }
          }
        }
        // A fragment of lane pair f: rows g (lane 8g + 2f, the low halves)
        // and g + 8 (lane 8g + 2f + 1), columns j0, j0 + 1 | j0 + 2, j0 + 3
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const uint32_t a[4] = {
                __byte_perm(xw[p][0][f], xw[p][1][f], 0x5410),
                __byte_perm(xw[p][0][f], xw[p][1][f], 0x7632),
                __byte_perm(xw[p][2][f], xw[p][3][f], 0x5410),
                __byte_perm(xw[p][2][f], xw[p][3][f], 0x7632)};
            float d[4];
            mma_bf16(d, a, bf.x, bf.y);
#pragma unroll
            for (int k = 0; k < 4; ++k)
              acc[p][f][k] = __fadd_rn(acc[p][f][k], d[k]);
          }
      }
    }

    // splits of one strip: add in split order into split 0
    if (S > 1) {
      if (s > 0) {
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int f = 0; f < 4; ++f)
#pragma unroll
            for (int k = 0; k < 4; ++k)
              red_s[warp][(p * 4 + f) * 4 + k][lane] = acc[p][f][k];
      }
      __syncthreads();
      if (s == 0) {
        for (int h = 1; h < S; ++h)
#pragma unroll
          for (int p = 0; p < NP; ++p)
#pragma unroll
            for (int f = 0; f < 4; ++f)
#pragma unroll
              for (int k = 0; k < 4; ++k)
                acc[p][f][k] = __fadd_rn(
                    acc[p][f][k], red_s[warp + h][(p * 4 + f) * 4 + k][lane]);
      }
      __syncthreads();  // red_s is free for the next row chunk
    }
    if (s != 0 || !strip_live || !lanes_live) continue;
    // fold the planes; acc[.][f][k] holds k = 0 row 2q lane 8g+2f, 1 row
    // 2q+1 lane 8g+2f, 2 row 2q lane 8g+2f+1, 3 row 2q+1 lane 8g+2f+1
    float o[2][8];
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float v = acc[0][f][k];
        if constexpr (NP == 3)
          v = __fadd_rn(__fadd_rn(acc[0][f][k], acc[1][f][k]), acc[2][f][k]);
        o[k & 1][2 * f + (k >> 1)] = v;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 2 * q + h;
      if (r >= TM) continue;
      float4* dst =
          reinterpret_cast<float4*>(out + ((size_t)i * TM + r) * Npad + c0);
      dst[0] = make_float4(o[h][0], o[h][1], o[h][2], o[h][3]);
      dst[1] = make_float4(o[h][4], o[h][5], o[h][6], o[h][7]);
    }
  }
}

// ------------------------------------------------------ scalar f32 body
constexpr int COLS = 128;     // output columns per CTA (one per thread)
constexpr int TM_CHUNK = 8;   // output rows per pass over the tiles
// tile (or panel) columns staged in shared memory at a time: any tile_k
// runs in chunks, and four groups' chunks stay within 48 KB
constexpr int K_CHUNK = 256;
constexpr int GROUPS = 4;     // tile-loop thread groups of a bucket CTA

// Barrier of one 128-thread group (ids 1..GROUPS; 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(COLS) : "memory");
}

// #5 over f32 X: four 128-thread groups split the tile loop (tiles
// t ≡ g mod 4) and add their sums in group order; each thread owns one
// output column, the current tile rows staged in shared memory as f32.
template <typename TT>
__global__ void __launch_bounds__(COLS * GROUPS)
bucket_scalar_kernel(const int* __restrict__ slab_ids,  // [ns, T]
                     const TT* __restrict__ tiles,      // [ns, T, TM, TK]
                     const float* __restrict__ x,       // [K, Npad]
                     float* __restrict__ out,           // [ns·TM, Npad]
                     int T, int TM, int TK, int Npad, int ncb) {
  // per group a [TM_CHUNK][min(TK, K_CHUNK)] tile buffer; reused for the
  // group sums
  extern __shared__ float smem[];
  const int c = threadIdx.x % COLS;
  const int g = threadIdx.x / COLS;
  float* tile_s = smem + (size_t)g * TM_CHUNK * min(TK, K_CHUNK);
  const int i = blockIdx.x / ncb;
  const int col = (blockIdx.x - i * ncb) * COLS + c;
  const bool live = col < Npad;

  for (int r0 = 0; r0 < TM; r0 += TM_CHUNK) {
    const int nr = min(TM_CHUNK, TM - r0);
    float acc[TM_CHUNK];
#pragma unroll
    for (int r = 0; r < TM_CHUNK; ++r) acc[r] = 0.f;
    for (int t = g; t < T; t += GROUPS) {
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
          const float xv = x[(xrow0 + k0 + k) * Npad + col];
#pragma unroll
          for (int r = 0; r < TM_CHUNK; ++r)
            acc[r] = __fmaf_rn(tile_s[r * kc + k], xv, acc[r]);
        }
      }
    }
    // group 0 adds the other groups' sums in group order
    __syncthreads();
    if (g > 0) {
#pragma unroll
      for (int r = 0; r < TM_CHUNK; ++r)
        smem[((g - 1) * TM_CHUNK + r) * COLS + c] = acc[r];
    }
    __syncthreads();
    if (g == 0 && live) {
      for (int r = 0; r < nr; ++r) {
        float v = acc[r];
        for (int h = 1; h < GROUPS; ++h)
          v = __fadd_rn(v, smem[((h - 1) * TM_CHUNK + r) * COLS + c]);
        out[((size_t)i * TM + r0 + r) * Npad + col] = v;
      }
    }
    __syncthreads();  // the sums are read before the next tile rows land
  }
}

// #6 over f32 panels and f32 X: one CTA per (strip slot, 128 columns).
__global__ void __launch_bounds__(COLS)
panel_scalar_kernel(const int* __restrict__ start,   // [ns]
                    const float* __restrict__ panels,  // [ns, TM, PK]
                    const float* __restrict__ x,     // [K, x_cols]
                    float* __restrict__ out,         // [ns·TM, x_cols]
                    int TM, int TK, int PK, int x_cols, int row_base,
                    int ncb) {
  extern __shared__ float pan_s[];  // [TM_CHUNK][min(TK, K_CHUNK)]
  const int kstep = min(TK, K_CHUNK);
  const int i = blockIdx.x / ncb;
  const int col = (blockIdx.x - i * ncb) * COLS + threadIdx.x;
  const bool live = col < x_cols;
  const size_t xrow0 = (size_t)row_base + (size_t)start[i] * TK;

  for (int r0 = 0; r0 < TM; r0 += TM_CHUNK) {
    const int nr = min(TM_CHUNK, TM - r0);
    float acc[TM_CHUNK];
#pragma unroll
    for (int r = 0; r < TM_CHUNK; ++r) acc[r] = 0.f;
    for (int k0 = 0; k0 < PK; k0 += kstep) {
      const int kc = min(kstep, PK - k0);
      __syncthreads();
      for (int q = threadIdx.x; q < TM_CHUNK * kc; q += COLS) {
        const int r = q / kc;
        pan_s[q] = r < nr ? panels[((size_t)i * TM + r0 + r) * PK + k0 +
                                   (q - r * kc)]
                          : 0.f;
      }
      __syncthreads();
      if (!live) continue;
#pragma unroll 8
      for (int k = 0; k < kc; ++k) {
        const float xv = x[(xrow0 + k0 + k) * x_cols + col];
#pragma unroll
        for (int r = 0; r < TM_CHUNK; ++r)
          acc[r] = __fmaf_rn(pan_s[r * kc + k], xv, acc[r]);
      }
    }
    if (live) {
      for (int r = 0; r < nr; ++r)
        out[((size_t)i * TM + r0 + r) * x_cols + col] = acc[r];
    }
  }
}

// ---------------------------------------------------------------- #8
constexpr int SPMV_WARPS = 4;  // warps per CTA

// One 16-byte tile chunk (8 bf16 or 4 f32 values) times the x values of
// the same columns, fused multiply-adds into acc in column order.
__device__ __forceinline__ float dot_chunk(uint4 t, const float* xv, float acc,
                                           const __nv_bfloat16*) {
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    acc = __fmaf_rn(__uint_as_float(w[k] << 16), xv[2 * k], acc);
    acc = __fmaf_rn(__uint_as_float(w[k] & 0xffff0000u), xv[2 * k + 1], acc);
  }
  return acc;
}
__device__ __forceinline__ float dot_chunk(uint4 t, const float* xv, float acc,
                                           const float*) {
  acc = __fmaf_rn(__uint_as_float(t.x), xv[0], acc);
  acc = __fmaf_rn(__uint_as_float(t.y), xv[1], acc);
  acc = __fmaf_rn(__uint_as_float(t.z), xv[2], acc);
  return __fmaf_rn(__uint_as_float(t.w), xv[3], acc);
}

// An item is (strip, block of 32 / LPR rows); S warps share it, each
// taking a contiguous range of the strip's T tiles. A tile row is read by
// LPR = 2^lpr_log2 lanes in 16-byte chunks (lane cl takes chunks cl, cl +
// LPR, ...), so one warp load covers the item's rows. A warp loads TB
// tiles' chunks and their x chunks before the FMAs.
template <typename TT, int TB>
__global__ void __launch_bounds__(SPMV_WARPS * 32)
bucket_spmv_kernel(const int* __restrict__ slab_ids,  // [ns, T]
                   const TT* __restrict__ tiles,      // [ns, T, TM, TK]
                   const float* __restrict__ x,       // [n_slabs, TK]
                   float* __restrict__ out,           // [ns, TM]
                   int ns, int T, int TM, int TK, int nrb, int S,
                   int lpr_log2) {
  constexpr int E = 16 / sizeof(TT);
  __shared__ float part[SPMV_WARPS][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int item = blockIdx.x * (SPMV_WARPS / S) + warp / S;
  const int w = warp % S;
  const bool live = item < ns * nrb;
  const int strip = live ? item / nrb : 0;
  const int rl = lane >> lpr_log2;
  const int r = ((live ? item % nrb : 0) << (5 - lpr_log2)) + rl;
  const int cl = lane & ((1 << lpr_log2) - 1);
  const int cpr = TK / E;
  const int per = (T + S - 1) / S;
  const int t_lo = min(T, w * per);
  const int t_hi = live && r < TM ? min(T, t_lo + per) : t_lo;
  const size_t tile_elems = (size_t)TM * TK;
  const TT* row = tiles + (size_t)strip * T * tile_elems + (size_t)r * TK;
  float acc = 0.f;
  for (int t0 = t_lo; t0 < t_hi; t0 += TB) {
    int sl[TB];
#pragma unroll
    for (int b = 0; b < TB; ++b)
      sl[b] = t0 + b < t_hi ? __ldg(slab_ids + (size_t)strip * T + t0 + b) : 0;
    for (int c = cl; c < cpr; c += 1 << lpr_log2) {
      uint4 tv[TB];
      float xv[TB][E];
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        tv[b] = t0 + b < t_hi
                    ? __ldg(reinterpret_cast<const uint4*>(
                          row + (t0 + b) * tile_elems + c * E))
                    : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int k = 0; k < E; k += 4) {
          const float4 f =
              t0 + b < t_hi
                  ? __ldg(reinterpret_cast<const float4*>(
                        x + (size_t)sl[b] * TK + c * E + k))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
          xv[b][k] = f.x;
          xv[b][k + 1] = f.y;
          xv[b][k + 2] = f.z;
          xv[b][k + 3] = f.w;
        }
      }
#pragma unroll
      for (int b = 0; b < TB; ++b) acc = dot_chunk(tv[b], xv[b], acc, tiles);
    }
  }
  // a row's LPR lanes, by a shuffle tree; then the S warps in split order
  for (int off = (1 << lpr_log2) >> 1; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (S == 1) {
    if (live && cl == 0 && r < TM) out[(size_t)strip * TM + r] = acc;
    return;
  }
  if (cl == 0) part[warp][rl] = acc;
  __syncthreads();
  if (live && w == 0 && cl == 0 && r < TM) {
    float s = part[warp][rl];
    for (int k = 1; k < S; ++k) s = __fadd_rn(s, part[warp + k][rl]);
    out[(size_t)strip * TM + r] = s;
  }
}

template <typename TT, int TB>
void launch_spmv(const int* slab_ids, const void* tiles, const float* x,
                 float* out, int ns, int T, int TM, int TK, int lpr_log2,
                 cudaStream_t st) {
  const int rows = 32 >> lpr_log2;  // rows an item covers
  const int nrb = (TM + rows - 1) / rows;
  const int S = T <= TB ? 1 : T <= 2 * TB ? 2 : 4;
  const int per_cta = SPMV_WARPS / S;
  const long long items = (long long)ns * nrb;
  bucket_spmv_kernel<TT, TB><<<(unsigned int)((items + per_cta - 1) / per_cta),
                               SPMV_WARPS * 32, 0, st>>>(
      slab_ids, (const TT*)tiles, x, out, ns, T, TM, TK, nrb, S, lpr_log2);
}

// LPR: the most lanes, up to 32, that split a tile row into whole 16-byte
// chunks (a power of two); TB: tiles a warp loads at once, as many as the
// strip has, up to 4.
template <typename TT>
int launch_spmv_any(const int* slab_ids, const void* tiles, const float* x,
                    float* out, int ns, int T, int TM, int TK,
                    cudaStream_t st) {
  constexpr int E = 16 / sizeof(TT);
  if (TK % 32 || (uintptr_t)tiles % 16 || (uintptr_t)x % 16)
    return FS_SHAPE_REFUSED;
  const int cpr = TK / E;
  int lpr_log2 = 0;
  while (lpr_log2 < 5 && (2 << lpr_log2) <= cpr) ++lpr_log2;
  if (T >= 4)
    launch_spmv<TT, 4>(slab_ids, tiles, x, out, ns, T, TM, TK, lpr_log2, st);
  else if (T >= 2)
    launch_spmv<TT, 2>(slab_ids, tiles, x, out, ns, T, TM, TK, lpr_log2, st);
  else
    launch_spmv<TT, 1>(slab_ids, tiles, x, out, ns, T, TM, TK, lpr_log2, st);
  return (int)cudaGetLastError();
}

// The MMA body's shape rules, in this one place: 16-byte X loads need
// 8-lane alignment, and a warp's 64 lanes must stay in one plane block.
// Other shapes return FS_SHAPE_REFUSED before any launch (the wrapper
// raises NotImplementedError on it).
template <typename TT, int XM>
int launch_mma(const int* idx, const void* tiles, const void* x, float* out,
               int ns, int T, int TM, int KW, int TK, int x_cols, int Npad,
               int NB, int row_base, cudaStream_t st) {
  if (Npad % 8 || x_cols % 8 || KW % 4 ||
      (XM == X_PLANES && (NB <= 0 || NB % WL)))
    return FS_SHAPE_REFUSED;
  const int U = T * ((KW + KC - 1) / KC);
  const int S = U >= 4 ? 4 : U >= 2 ? 2 : 1;
  const int per_cta = MW / S;
  const dim3 grid((unsigned int)((ns + per_cta - 1) / per_cta),
                  (unsigned int)((Npad + WL - 1) / WL));
  tile_mma_kernel<TT, XM><<<grid, MW * 32, 0, st>>>(
      idx, (const TT*)tiles, x, out, ns, T, TM, KW, TK, x_cols, Npad, NB,
      row_base, S);
  return (int)cudaGetLastError();
}

template <typename TT>
int launch_bucket_scalar(const int* slab, const void* tiles, const void* x,
                         float* out, int ns, int T, int TM, int TK, int Npad,
                         cudaStream_t st) {
  const int ncb = (Npad + COLS - 1) / COLS;
  const int tile_floats = GROUPS * TM_CHUNK * (TK < K_CHUNK ? TK : K_CHUNK);
  const int sum_floats = (GROUPS - 1) * TM_CHUNK * COLS;
  const size_t smem =
      sizeof(float) * (tile_floats > sum_floats ? tile_floats : sum_floats);
  bucket_scalar_kernel<TT><<<(unsigned int)ns * ncb, COLS * GROUPS, smem, st>>>(
      slab, (const TT*)tiles, (const float*)x, out, T, TM, TK, Npad, ncb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 int8, 1 bf16, 2 f32. Returns cudaGetLastError(); an
// unsupported combination returns cudaErrorInvalidValue and a shape the MMA
// body does not take FS_SHAPE_REFUSED, both before any launch.
int fs_bucket_spmm(const int* slab_ids, const void* tiles, const void* x,
                   float* out, int ns, int T, int TM, int TK, int x_cols,
                   int Npad, int NB, int planes, int tile_dt, int x_dt,
                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (tile_dt == 1 && x_dt == 1 && planes == 3)
    return launch_mma<__nv_bfloat16, X_PLANES>(slab_ids, tiles, x, out, ns, T,
                                               TM, TK, TK, x_cols, Npad, NB,
                                               0, st);
  if (tile_dt == 1 && x_dt == 1 && planes == 1)
    return launch_mma<__nv_bfloat16, X_BF16>(slab_ids, tiles, x, out, ns, T,
                                             TM, TK, TK, x_cols, Npad, NB, 0,
                                             st);
  if (tile_dt == 2 && x_dt == 2 && planes == 1)
    return launch_bucket_scalar<float>(slab_ids, tiles, x, out, ns, T, TM, TK,
                                       Npad, st);
  if (tile_dt == 1 && x_dt == 2 && planes == 1)
    return launch_bucket_scalar<__nv_bfloat16>(slab_ids, tiles, x, out, ns, T,
                                               TM, TK, Npad, st);
  return (int)cudaErrorInvalidValue;
}

// A panel is one item of width PK: the MMA body reads it as a strip of T = 1.
int fs_panel_spmm(const int* start, const void* panels, const void* x,
                  float* out, int ns, int TM, int TK, int PK, int x_cols,
                  int row_base, int panel_dt, int x_dt, int split,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (split && x_dt == 2 && panel_dt == 0)
    return launch_mma<int8_t, X_SPLIT>(start, panels, x, out, ns, 1, TM, PK,
                                       TK, x_cols, x_cols, 0, row_base, st);
  if (split && x_dt == 2 && panel_dt == 1)
    return launch_mma<__nv_bfloat16, X_SPLIT>(start, panels, x, out, ns, 1,
                                              TM, PK, TK, x_cols, x_cols, 0,
                                              row_base, st);
  if (!split && x_dt == 1 && panel_dt == 0)
    return launch_mma<int8_t, X_BF16>(start, panels, x, out, ns, 1, TM, PK,
                                      TK, x_cols, x_cols, 0, row_base, st);
  if (!split && x_dt == 1 && panel_dt == 1)
    return launch_mma<__nv_bfloat16, X_BF16>(start, panels, x, out, ns, 1, TM,
                                             PK, TK, x_cols, x_cols, 0,
                                             row_base, st);
  if (!split && x_dt == 2 && panel_dt == 2) {
    const int ncb = (x_cols + COLS - 1) / COLS;
    panel_scalar_kernel<<<(unsigned int)ns * ncb, COLS,
                          TM_CHUNK * (TK < K_CHUNK ? TK : K_CHUNK) *
                              sizeof(float),
                          st>>>(start, (const float*)panels, (const float*)x,
                                out, TM, TK, PK, x_cols, row_base, ncb);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

int fs_bucket_spmv(const int* slab_ids, const void* tiles, const float* x,
                   float* out, int ns, int T, int TM, int TK, int tile_dt,
                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (tile_dt == 1)
    return launch_spmv_any<__nv_bfloat16>(slab_ids, tiles, x, out, ns, T, TM,
                                          TK, st);
  if (tile_dt == 2)
    return launch_spmv_any<float>(slab_ids, tiles, x, out, ns, T, TM, TK, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
