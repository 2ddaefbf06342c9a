// Hand-written Hopper (sm_90a) kernels for the mono int8-panel BSR path.
//
// Four kernels, each the CUDA counterpart of one Pallas TPU kernel in
// fastsparse/ops/pallas/bsr_spmm.py, and one pair that replaces XLA ops:
//
//   fs_colmax      <- colmax_pallas         per-column max|x| of f32 X
//   fs_quant3      <- quant3_planes_pallas  radix-256 int8 planes of X,
//                                           written K-major
//   fs_encode_colmax, fs_encode_planes      the narrow mono planes and the
//                  <- XLA ops (_quant3_narrow, the dense-column planes):
//                                           X read in place (strides, an
//                                           optional row index), the
//                                           scale computed in-kernel
//   fs_mono_panel  <- mono_panel_spmm       Y = A·X over the mono item list
//                                           (fold "i8w" and the narrow raw
//                                           int8 mode; K-major X planes)
//   fs_mono_group  <- mono_group_spmm       one item per strip, write-once
//                                           (the narrow halo engine; K-major
//                                           X planes)
//
// Every launcher takes raw device pointers, sizes and a cudaStream_t, runs
// on that stream, allocates nothing and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
//
// Bounds on this card:
// * colmax and quant3 (and the encode pair) are elementwise/reduction
//   passes over X: bound by device-memory bytes (read 4 B, write 0 or 3 B
//   per element). colmax: one thread per column stripe, coalesced along
//   X's lanes. quant3 writes its planes K-major, [3·Npad, K] (the
//   transpose of the reference's lane layout, which s8 wgmma needs for B):
//   a block quantizes a 128 k x 32 column tile with loads coalesced along
//   the lanes, packs each column's 4 consecutive k of a plane into a word
//   in shared memory and writes each plane row's 128 bytes as one warp's
//   coalesced words.
// * mono_panel is bound by int8 multiply-adds at N=128 (each panel byte
//   meets 3·128 X lanes) and, at the headline's 6 chunks an item, by the
//   panel bytes. mono_group (the halo layout behind SpMV and N <= 8: 32
//   raw lanes, each panel byte meets 32 of them) is bound by the panel
//   bytes alone. Both run the s8 tensor-core engine (s8_engine.cuh) at TM
//   >= 64 with width·TK a multiple of 128 (the shapes build_bsr makes at
//   its default tile sizes): output tiles of (strip, 64 or 128 rows, 64
//   output columns = 192 plane lanes; narrow: all nb lanes), walked by a
//   persistent grid, the strip's items (mono_group: its one item) through
//   one TMA ring, wgmma m64n192k32 (narrow m64n{32..128}k32), the fold per
//   item in registers. Other shapes (TM of 8 or 32) keep the dp4a body
//   below (4 int8 MACs per instruction, no tensor cores): panels and the
//   K-major planes are k-contiguous, so 4 consecutive k load as one int32.

// Ordering: the TPU kernel walks its item grid in order and sets the
// output block on a strip's first item, adding the others. CUDA blocks run
// concurrently, so here each (strip, row block, column block) output tile
// belongs to one CTA, which loops over that strip's items in ascending
// order (strip_ptr). Every output element is written by exactly one CTA,
// with no atomics, and the f32 accumulation order equals the reference's.
//
// Arithmetic: quant3 uses __fmul_rn + __float2int_rn (round half to even,
// as jnp.round/torch.round), integer carries with arithmetic shifts. The
// i8w epilogue is ((d0·65536 + d1·256) + d2)·s with explicit _rn
// intrinsics, so no FMA contraction can change a bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "s8_engine.cuh"

namespace {

// ---------------------------------------------------------------- colmax
constexpr int CM_COLS = 32;     // columns per block (one warp wide)
constexpr int CM_ROWS = 8;      // row phases per block (threadIdx.y)
constexpr int CM_CHUNK = 512;   // rows per block

__global__ void colmax_kernel(const float* __restrict__ x, int K, int N,
                              unsigned int* __restrict__ out) {
  __shared__ float red[CM_ROWS][CM_COLS];
  const int col = blockIdx.x * CM_COLS + threadIdx.x;
  const int r0 = blockIdx.y * CM_CHUNK;
  const int r1 = min(r0 + CM_CHUNK, K);
  float m = 0.0f;
  if (col < N) {
    for (int r = r0 + threadIdx.y; r < r1; r += CM_ROWS) {
      m = fmaxf(m, fabsf(x[(size_t)r * N + col]));
    }
  }
  red[threadIdx.y][threadIdx.x] = m;
  __syncthreads();
  if (threadIdx.y == 0 && col < N) {
    for (int t = 1; t < CM_ROWS; ++t) m = fmaxf(m, red[t][threadIdx.x]);
    // m >= 0: the IEEE bit patterns of non-negative floats order like
    // unsigned ints, so an integer atomicMax is an exact float max.
    atomicMax(out + col, __float_as_uint(m));
  }
}

// ---------------------------------------------------------------- quant3
constexpr int Q3_K = 128;        // k rows per block
constexpr int Q3_W = Q3_K / 4;   // k words per plane row of a block
constexpr int Q3_C = 32;         // columns per block (one warp wide)
constexpr int Q3_ROWS = 8;       // word phases per block (threadIdx.y)
static_assert(Q3_W == Q3_C, "a warp writes one plane row's words");

__device__ __forceinline__ void quant3_one(float v, float si, int& q0,
                                           int& q1, int& q2) {
  const int i = __float2int_rn(__fmul_rn(v, si));
  q2 = ((i + 128) & 255) - 128;
  const int i1 = (i - q2) >> 8;
  q1 = ((i1 + 128) & 255) - 128;
  q0 = (i1 - q1) >> 8;
}

__global__ void quant3_kernel(const float* __restrict__ x,
                              const float* __restrict__ sinv, int K, int N,
                              int NB, int8_t* __restrict__ out) {
  // [plane][column][4 k bytes]; +1 word a row: conflict-free column writes
  __shared__ uint32_t sq[3][Q3_C][Q3_W + 1];
  const int k0 = blockIdx.x * Q3_K;
  const int c0 = blockIdx.y * Q3_C;
  const int c = c0 + threadIdx.x;
  const float si = c < N ? sinv[c] : 0.0f;
  for (int w = threadIdx.y; w < Q3_W; w += Q3_ROWS) {
    uint32_t p0 = 0, p1 = 0, p2 = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + 4 * w + j;
      int q0 = 0, q1 = 0, q2 = 0;
      if (k < K && c < N) quant3_one(x[(size_t)k * N + c], si, q0, q1, q2);
      p0 |= (uint32_t)(uint8_t)q0 << (8 * j);
      p1 |= (uint32_t)(uint8_t)q1 << (8 * j);
      p2 |= (uint32_t)(uint8_t)q2 << (8 * j);
    }
    sq[0][threadIdx.x][w] = p0;
    sq[1][threadIdx.x][w] = p1;
    sq[2][threadIdx.x][w] = p2;
  }
  __syncthreads();
  // plane p of column c = j·NB + cc is row j·3·NB + p·NB + cc of out. Warp
  // y writes columns y, y+8, ...: one plane row's 128 bytes per store, as
  // 32 words when K keeps them aligned, else byte by byte.
  for (int cl = threadIdx.y; cl < Q3_C; cl += Q3_ROWS) {
    const int cg = c0 + cl;
    if (cg >= N) break;
    const int j = cg / NB;
    const size_t row0 = (size_t)j * 3 * NB + (cg - j * NB);
#pragma unroll
    for (int pl = 0; pl < 3; ++pl) {
      int8_t* o = out + (row0 + (size_t)pl * NB) * K + k0;
      if ((K & 3) == 0) {
        if (k0 + 4 * (int)threadIdx.x < K) {
          reinterpret_cast<uint32_t*>(o)[threadIdx.x] =
              sq[pl][cl][threadIdx.x];
        }
      } else {
        for (int e = threadIdx.x; e < Q3_K && k0 + e < K; e += Q3_C) {
          o[e] = (int8_t)(sq[pl][cl][e >> 2] >> (8 * (e & 3)));
        }
      }
    }
  }
}

// ---------------------------------------------------------------- encode
// The narrow mono planes and the dense-column planes in two launches,
// over X read in place: row k of the encoded operand is X's row rows[k]
// (or k when rows is null) for k < K_x, zero past it; its column c is X's
// column c for c < N, zero up to Npad; X's element (r, c) sits at
// x[r·ld + c·cs]. encode_colmax takes each column's max|x| into bits that
// start at zero; encode_planes computes each column's scale s =
// (m > 0 ? m : 1)·S_UNIT and 1/s with _rn intrinsics, as the torch ops
// they replace do (a product by the scalar as f32, an IEEE division),
// quantizes as quant3_kernel does, and writes the planes K-major as
// [n_out, K]: row p·Npad + c is plane p of column c, rows from 3·Npad to
// n_out zero, and the first k block writes s.
constexpr float EN_S_UNIT = (float)(1.0 / (127.0 * 65536.0));
// loads a thread issues together in encode_colmax: X is often small (a
// 5,376-row gather), so blocks are short and their loads all in flight
constexpr int EN_LOADS = 8;

__device__ __forceinline__ float x_at(const float* __restrict__ x,
                                      const int32_t* __restrict__ rows,
                                      int k, int c, long long ld,
                                      long long cs) {
  const long long r = rows ? (long long)rows[k] : (long long)k;
  return x[r * ld + (long long)c * cs];
}

// Block (32, 8): lane tx reads column blockIdx.x·cw + tx % cw of rows
// phased by tx / cw, so a warp covers 32 / cw rows of cw columns (cw: the
// power of two at least N, at most 32); a block covers EN_LOADS·8·32/cw
// rows.
__global__ void encode_colmax_kernel(const float* __restrict__ x,
                                     const int32_t* __restrict__ rows,
                                     int K_x, int N, long long ld,
                                     long long cs, int cw,
                                     unsigned int* __restrict__ mbits) {
  __shared__ float red[CM_ROWS][CM_COLS];
  const int rw = CM_COLS / cw;
  const int lane_col = threadIdx.x % cw;
  const int col = blockIdx.x * cw + lane_col;
  const int step = CM_ROWS * rw;
  const int r0 = blockIdx.y * EN_LOADS * step;
  const int r1 = min(r0 + EN_LOADS * step, K_x);
  const int r = r0 + threadIdx.y * rw + threadIdx.x / cw;
  float v[EN_LOADS];
#pragma unroll
  for (int i = 0; i < EN_LOADS; ++i) {
    v[i] = col < N && r + i * step < r1
               ? fabsf(x_at(x, rows, r + i * step, col, ld, cs))
               : 0.0f;
  }
  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < EN_LOADS; ++i) m = fmaxf(m, v[i]);
  red[threadIdx.y][threadIdx.x] = m;
  __syncthreads();
  if (threadIdx.y == 0 && (int)threadIdx.x < cw && col < N) {
    for (int t = 0; t < CM_ROWS; ++t) {
      for (int j = 0; j < rw; ++j) m = fmaxf(m, red[t][j * cw + lane_col]);
    }
    atomicMax(mbits + col, __float_as_uint(m));  // m >= 0: see colmax
  }
}

// Block (32, 8) over Q3_K k x Q3_C columns, as quant3_kernel.
__global__ void encode_planes_kernel(const float* __restrict__ x,
                                     const int32_t* __restrict__ rows,
                                     const unsigned int* __restrict__ mbits,
                                     int K_x, int N, long long ld,
                                     long long cs, int K, int Npad,
                                     int n_out, int8_t* __restrict__ out,
                                     float* __restrict__ scale) {
  __shared__ uint32_t sq[3][Q3_C][Q3_W + 1];
  const int k0 = blockIdx.x * Q3_K;
  const int c0 = blockIdx.y * Q3_C;
  const int c = c0 + threadIdx.x;
  float si = 0.0f;
  if (c < Npad) {
    const float m = c < N ? __uint_as_float(mbits[c]) : 0.0f;
    const float s = __fmul_rn(m > 0.0f ? m : 1.0f, EN_S_UNIT);
    si = __fdiv_rn(1.0f, s);
    if (blockIdx.x == 0 && threadIdx.y == 0) scale[c] = s;
  }
  // a thread's 16 loads issued together, then quantized (a zero, past X,
  // quantizes to zero planes)
  constexpr int T = Q3_W / Q3_ROWS;
  float v[T][4];
#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + 4 * (threadIdx.y + t * Q3_ROWS) + j;
      v[t][j] = k < K_x && c < N ? x_at(x, rows, k, c, ld, cs) : 0.0f;
    }
  }
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int w = threadIdx.y + t * Q3_ROWS;
    uint32_t p0 = 0, p1 = 0, p2 = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int q0, q1, q2;
      quant3_one(v[t][j], si, q0, q1, q2);
      p0 |= (uint32_t)(uint8_t)q0 << (8 * j);
      p1 |= (uint32_t)(uint8_t)q1 << (8 * j);
      p2 |= (uint32_t)(uint8_t)q2 << (8 * j);
    }
    sq[0][threadIdx.x][w] = p0;
    sq[1][threadIdx.x][w] = p1;
    sq[2][threadIdx.x][w] = p2;
  }
  __syncthreads();
  // warp y writes plane rows of columns y, y+8, ... (then, in the first
  // column block, the zero rows), 128 bytes a store as in quant3_kernel
  const int n_rows = min(Q3_C, Npad - c0) * 3;
  const int n_zero = blockIdx.y == 0 ? n_out - 3 * Npad : 0;
  for (int e = threadIdx.y; e < n_rows + n_zero; e += Q3_ROWS) {
    const int cl = e / 3, pl = e - 3 * cl;
    const size_t row = e < n_rows ? (size_t)pl * Npad + c0 + cl
                                  : (size_t)3 * Npad + (e - n_rows);
    int8_t* o = out + row * K + k0;
    if ((K & 3) == 0) {
      if (k0 + 4 * (int)threadIdx.x < K) {
        reinterpret_cast<uint32_t*>(o)[threadIdx.x] =
            e < n_rows ? sq[pl][cl][threadIdx.x] : 0u;
      }
    } else {
      for (int b = threadIdx.x; b < Q3_K && k0 + b < K; b += Q3_C) {
        o[b] = e < n_rows ? (int8_t)(sq[pl][cl][b >> 2] >> (8 * (b & 3)))
                          : (int8_t)0;
      }
    }
  }
}

// ------------------------------------------------------------------ mono
// CTA tile: BM output rows x BC output columns; 256 threads as 32 (tx,
// columns) x 8 (ty, rows). Each thread owns RPT rows (ty + 8t) and CPT
// columns (tx + 32c), each needing P plane dots (P=3: i8w radix planes,
// P=1: raw narrow lanes). X is K-major, [n_lanes, x_ld].
constexpr int MT_THREADS = 256;
constexpr int MT_BM = 32;
constexpr int MT_RPT = MT_BM / 8;
constexpr int MT_BK = 64;            // k per shared-memory chunk
constexpr int MT_K4 = MT_BK / 4;     // int32 words per k chunk
constexpr int MT_XSTRIDE = MT_K4 + 1;  // +1 word: conflict-free lane rows

template <int P, int CPT, bool GROUPED>
__global__ void __launch_bounds__(MT_THREADS)
mono_kernel(const int32_t* __restrict__ window,     // [ni] or [ns/G]
            const int32_t* __restrict__ strip_ptr,  // [n_strips+1] | null
            const int32_t* __restrict__ start_rel,  // [ni] | [ns]
            const int8_t* __restrict__ panels,      // [ni, TM, PK]
            const int8_t* __restrict__ x,           // [n_lanes, x_ld]
            const float* __restrict__ scale,        // [n_out] (P==3)
            float* __restrict__ out,                // [n_strips*TM, n_out]
            int TM, int TK, int PK, int win_stride, int G, int n_lanes,
            int x_ld, int n_out, int NB, int n_row_blocks) {
  constexpr int BC = 32 * CPT;
  __shared__ int32_t As[MT_BM][MT_K4];
  __shared__ int32_t Xs[P * BC][MT_XSTRIDE];

  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  const int strip = blockIdx.x / n_row_blocks;
  const int rb = blockIdx.x - strip * n_row_blocks;
  const int c0 = blockIdx.y * BC;

  // X lane of smem lane l = p*BC + t (t in [0, BC)) for output column c0+t
  int lane_base[P];
  if constexpr (P == 3) {
    const int j = c0 / NB;
    for (int p = 0; p < P; ++p) lane_base[p] = j * 3 * NB + p * NB + (c0 - j * NB);
  } else {
    lane_base[0] = c0;
  }
  const int lane_end = n_lanes;

  int begin, end;
  if (GROUPED) {
    begin = strip;
    end = strip + 1;
  } else {
    begin = strip_ptr[strip];
    end = strip_ptr[strip + 1];
  }

  float res[MT_RPT][CPT];
#pragma unroll
  for (int t = 0; t < MT_RPT; ++t)
#pragma unroll
    for (int c = 0; c < CPT; ++c) res[t][c] = 0.0f;

  for (int it = begin; it < end; ++it) {
    const int win = GROUPED ? window[it / G] : window[it];
    const size_t xrow0 = (size_t)(win * win_stride + start_rel[it]) * TK;
    const int8_t* pan = panels + (size_t)it * TM * PK;

    int acc[MT_RPT][CPT][P];
#pragma unroll
    for (int t = 0; t < MT_RPT; ++t)
#pragma unroll
      for (int c = 0; c < CPT; ++c)
#pragma unroll
        for (int p = 0; p < P; ++p) acc[t][c][p] = 0;

    for (int k0 = 0; k0 < PK; k0 += MT_BK) {
      __syncthreads();  // previous chunk fully consumed
      // panel chunk: BM rows x BK bytes as int32 words (k-contiguous)
      for (int q = tid; q < MT_BM * MT_K4; q += MT_THREADS) {
        const int row = q / MT_K4;
        const int k4 = q - row * MT_K4;
        const int r = rb * MT_BM + row;
        int32_t v = 0;
        if (r < TM) {
          v = *reinterpret_cast<const int32_t*>(pan + (size_t)r * PK + k0 + 4 * k4);
        }
        As[row][k4] = v;
      }
      // X chunk: (P*BC) lane rows x BK k; 4 consecutive k of a lane row
      // load as one word
      for (int q = tid; q < P * BC * MT_K4; q += MT_THREADS) {
        const int l = q / MT_K4;
        const int k4 = q - l * MT_K4;
        const int p = l / BC;
        const int lane = lane_base[p] + (l - p * BC);
        uint32_t v = 0;
        if (lane < lane_end) {
          v = *reinterpret_cast<const uint32_t*>(
              x + (size_t)lane * x_ld + xrow0 + k0 + 4 * k4);
        }
        Xs[l][k4] = (int32_t)v;
      }
      __syncthreads();
#pragma unroll
      for (int k4 = 0; k4 < MT_K4; ++k4) {
        int a[MT_RPT];
#pragma unroll
        for (int t = 0; t < MT_RPT; ++t) a[t] = As[ty + 8 * t][k4];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const int xv = Xs[p * BC + tx + 32 * c][k4];
#pragma unroll
            for (int t = 0; t < MT_RPT; ++t) {
              acc[t][c][p] = __dp4a(a[t], xv, acc[t][c][p]);
            }
          }
        }
      }
    }

    // per-item f32 epilogue, then set (first item) or add in item order
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = c0 + tx + 32 * c;
      float s = 0.0f;
      if constexpr (P == 3) {
        if (col < n_out) s = scale[col];
      }
#pragma unroll
      for (int t = 0; t < MT_RPT; ++t) {
        float d;
        if constexpr (P == 3) {
          const float hi = __fmul_rn(__int2float_rn(acc[t][c][0]), 65536.0f);
          const float mid = __fmul_rn(__int2float_rn(acc[t][c][1]), 256.0f);
          const float lo = __int2float_rn(acc[t][c][2]);
          d = __fmul_rn(__fadd_rn(__fadd_rn(hi, mid), lo), s);
        } else {
          d = __int2float_rn(acc[t][c][0]);
        }
        res[t][c] = (it == begin) ? d : __fadd_rn(res[t][c], d);
      }
    }
  }

#pragma unroll
  for (int t = 0; t < MT_RPT; ++t) {
    const int r = rb * MT_BM + ty + 8 * t;
    if (r >= TM) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = c0 + tx + 32 * c;
      if (col < n_out) out[((size_t)strip * TM + r) * n_out + col] = res[t][c];
    }
  }
}

// The s8 engine takes a mono item source when strips split into 64-row
// warpgroup parts, items into whole 128-byte k chunks, and X (K-major,
// x_ld bytes a lane row) has the 16-byte row pitch and both operands the
// 16-byte bases that TMA needs.
bool engine_shape(int TM, int PK, int x_ld, const int8_t* panels,
                  const int8_t* x) {
  return TM % s8e::WG_ROWS == 0 && PK % s8e::KC == 0 && x_ld % 16 == 0 &&
         reinterpret_cast<uintptr_t>(panels) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

bool narrow_lanes(int n) {
  return n == 32 || n == 64 || n == 96 || n == 128;
}

// Consumer warpgroups of an engine launch: two (128-row tiles) where the
// strip height allows, else one. On the headline's halo layout (200 strips
// of 256 rows: 400 tiles, 3.03 rounds of 132 SMs, or 800 one-warpgroup
// tiles, 6.06 rounds) the two read level on an H100 (PERF.md).
int engine_nwg(int TM) { return TM % 128 == 0 ? 2 : 1; }

// Raw narrow lanes on the engine: one column block of all n_lanes lanes
// (m64n{n_lanes}k32); p holds the item source.
int engine_narrow(s8e::Params p, const int8_t* panels, long long a_rows,
                  int PK, const int8_t* x, int n_lanes, int x_ld,
                  long long tiles, cudaStream_t st) {
  p.grp = n_lanes;
  p.n_col_blocks = 1;
  p.n_out = n_lanes;
  switch (n_lanes) {
    case 32:
      return s8e::launch<32, 1>(panels, a_rows, PK, x, n_lanes, x_ld, p,
                                tiles, st);
    case 64:
      return s8e::launch<64, 1>(panels, a_rows, PK, x, n_lanes, x_ld, p,
                                tiles, st);
    case 96:
      return s8e::launch<96, 1>(panels, a_rows, PK, x, n_lanes, x_ld, p,
                                tiles, st);
    default:
      return s8e::launch<128, 1>(panels, a_rows, PK, x, n_lanes, x_ld, p,
                                 tiles, st);
  }
}

}  // namespace

extern "C" {

int fs_colmax(const float* x, int K, int N, float* out, void* stream) {
  if (K > 0 && N > 0) {
    dim3 grid((N + CM_COLS - 1) / CM_COLS, (K + CM_CHUNK - 1) / CM_CHUNK);
    dim3 block(CM_COLS, CM_ROWS);
    colmax_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        x, K, N, reinterpret_cast<unsigned int*>(out));
  }
  return (int)cudaGetLastError();
}

int fs_quant3(const float* x, const float* sinv, int K, int N, int NB,
              int8_t* out, void* stream) {
  if (K > 0 && N > 0) {
    dim3 grid((K + Q3_K - 1) / Q3_K, (N + Q3_C - 1) / Q3_C);
    dim3 block(Q3_C, Q3_ROWS);
    quant3_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(x, sinv, K, N,
                                                            NB, out);
  }
  return (int)cudaGetLastError();
}

// rows: int32 [K_x] or null; mbits: [N] zeroed before the call.
int fs_encode_colmax(const float* x, const int32_t* rows, int K_x, int N,
                     long long ld, long long cs, unsigned int* mbits,
                     void* stream) {
  if (K_x > 0 && N > 0) {
    int cw = 1;
    while (cw < N && cw < CM_COLS) cw *= 2;
    const int span = EN_LOADS * CM_ROWS * (CM_COLS / cw);
    dim3 grid((N + cw - 1) / cw, (K_x + span - 1) / span);
    dim3 block(CM_COLS, CM_ROWS);
    encode_colmax_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        x, rows, K_x, N, ld, cs, cw, mbits);
  }
  return (int)cudaGetLastError();
}

// out: int8 [n_out, K] with n_out >= 3·Npad, Npad >= N; scale: f32 [Npad].
int fs_encode_planes(const float* x, const int32_t* rows,
                     const unsigned int* mbits, int K_x, int N, long long ld,
                     long long cs, int K, int Npad, int n_out, int8_t* out,
                     float* scale, void* stream) {
  if (Npad < N || n_out < 3 * Npad) return -1;
  if (Npad > 0) {
    dim3 grid(K > 0 ? (K + Q3_K - 1) / Q3_K : 1, (Npad + Q3_C - 1) / Q3_C);
    dim3 block(Q3_C, Q3_ROWS);
    encode_planes_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        x, rows, mbits, K_x, N, ld, cs, K, Npad, n_out, out, scale);
  }
  return (int)cudaGetLastError();
}

// fold: 1 = "i8w" (x holds nj blocks of [q0|q1|q2] NB lanes each, n_lanes
// = 3·n_out, scale [n_out]); 0 = raw narrow int8 (n_lanes = n_out). x is
// K-major: [n_lanes, x_ld] with x_ld the X rows; TK, x_ld and x's base
// multiples of 4 (the wrapper checks), so a lane's 4 k load as one word.
int fs_mono_panel(const int32_t* window, const int32_t* strip_ptr,
                  const int32_t* start_rel, const int8_t* panels,
                  const int8_t* x, const float* scale, float* out,
                  int n_items, int n_strips, int TM, int TK, int PK,
                  int win_slabs, int n_lanes, int x_ld, int n_out, int NB,
                  int fold, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n_strips <= 0 || n_out <= 0) return (int)cudaGetLastError();
  if (engine_shape(TM, PK, x_ld, panels, x) && n_items > 0 &&
      (fold ? NB % 64 == 0 : narrow_lanes(n_lanes))) {
    s8e::Params p{};
    p.items = s8e::ITEMS_PANEL;
    p.window = window;
    p.strip_ptr = strip_ptr;
    p.start_rel = start_rel;
    p.out = out;
    p.nwg = engine_nwg(TM);
    p.n_row_blocks = TM / (s8e::WG_ROWS * p.nwg);
    p.TM = TM;
    p.TK = TK;
    p.win_stride = win_slabs;
    p.group = 1;
    p.k_chunks = PK / s8e::KC;
    p.out_rows = n_strips * TM;
    const long long a_rows = (long long)n_items * TM;
    const long long tiles = (long long)n_strips * p.n_row_blocks;
    if (!fold) {
      return engine_narrow(p, panels, a_rows, PK, x, n_lanes, x_ld, tiles,
                           st);
    }
    p.scale = scale;
    p.grp = NB;
    p.n_col_blocks = n_out / 64;
    p.n_out = n_out;
    return s8e::launch<64, 3>(panels, a_rows, PK, x, n_lanes, x_ld, p, tiles,
                              st);
  }
  const int n_row_blocks = (TM + MT_BM - 1) / MT_BM;
  if (fold) {
    dim3 grid(n_strips * n_row_blocks, (n_out + 63) / 64);
    mono_kernel<3, 2, false><<<grid, MT_THREADS, 0, st>>>(
        window, strip_ptr, start_rel, panels, x, scale, out, TM, TK, PK,
        win_slabs, 1, n_lanes, x_ld, n_out, NB, n_row_blocks);
  } else {
    dim3 grid(n_strips * n_row_blocks, (n_out + 31) / 32);
    mono_kernel<1, 1, false><<<grid, MT_THREADS, 0, st>>>(
        window, strip_ptr, start_rel, panels, x, nullptr, out, TM, TK, PK,
        win_slabs, 1, n_lanes, x_ld, n_out, NB, n_row_blocks);
  }
  return (int)cudaGetLastError();
}

// Narrow halo engine: strip s is one item, reading X rows from
// (windows[s / G]·stride + start_rel[s])·TK of the un-halo'd narrow planes
// x, K-major [n_lanes, x_ld]; out [ns·TM, n_lanes].
int fs_mono_group(const int32_t* windows, const int32_t* start_rel,
                  const int8_t* panels, const int8_t* x, float* out, int ns,
                  int TM, int TK, int PK, int stride, int G, int n_lanes,
                  int x_ld, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ns <= 0 || n_lanes <= 0) return (int)cudaGetLastError();
  if (engine_shape(TM, PK, x_ld, panels, x) && narrow_lanes(n_lanes)) {
    s8e::Params p{};
    p.items = s8e::ITEMS_HALO;
    p.window = windows;
    p.start_rel = start_rel;
    p.out = out;
    p.nwg = engine_nwg(TM);
    p.n_row_blocks = TM / (s8e::WG_ROWS * p.nwg);
    p.TM = TM;
    p.TK = TK;
    p.win_stride = stride;
    p.group = G;
    p.k_chunks = PK / s8e::KC;
    p.out_rows = ns * TM;
    return engine_narrow(p, panels, (long long)ns * TM, PK, x, n_lanes, x_ld,
                         (long long)ns * p.n_row_blocks, st);
  }
  const int n_row_blocks = (TM + MT_BM - 1) / MT_BM;
  dim3 grid(ns * n_row_blocks, (n_lanes + 31) / 32);
  mono_kernel<1, 1, true><<<grid, MT_THREADS, 0, st>>>(
      windows, nullptr, start_rel, panels, x, nullptr, out, TM, TK, PK,
      stride, G, n_lanes, x_ld, n_lanes, n_lanes, n_row_blocks);
  return (int)cudaGetLastError();
}

}  // extern "C"
