// Hand-written Hopper (sm_90a) kernels for the hybrid format's dense-column
// block: the CUDA counterpart of densecols_spmm_pallas in
// fastsparse/ops/pallas/bsr_spmm.py.
//
//   fs_densecols  Y[r, n] = ((f32(d0)·65536 + f32(d1)·256) + f32(d2))·s[n]
//                 with d_p = Σ_k block[r, k]·q_p[k, n]  (exact s32)
//
// block is int8 [nrow, D] (0/1 cells, k-contiguous rows); q3t holds the
// int8 radix-256 planes of the selected X rows transposed, [3N, D]: row
// p·N + n is plane p of column n, k-contiguous (the transpose of the
// reference's [D, 3N] layout; the X prep writes it so); s is the f32 per-column
// scale [N].
//
// Bound on this card: the block is the dominant operand (a few hundred MB
// at the Macau/ECFP shapes). At N=1 the kernel is bound by its bytes; from
// N of a few dozen on by int8 multiply-adds (3·N per block byte).
//
// Two bodies, chosen by shape in the launcher:
// * N >= 9 with D % 16 == 0 and 16-byte aligned operands (every DenseCols
//   build_hybrid makes: D is a multiple of 128): the s8 tensor-core engine
//   (s8_engine.cuh: a TMA ring and wgmma m64n192k32), output tiles of 128
//   block rows x 64 output columns (three 64-row plane boxes of q3t),
//   walked round robin by a persistent grid. The column blocks of one row
//   block are neighbouring tiles, so they run together and read the
//   block's chunks at about the same time: the block comes from device
//   memory about once (270 MB for the ECFP forward block) and from L2 for
//   the other column blocks (N=128: twice in all, N=256: four times). A
//   2-CTA cluster multicasting A, or a 128-column tile (192 s32
//   accumulators a thread), would read it once from L2 too; both cost more
//   code than the L2 hits they save while the tensor cores, not the bytes,
//   bound N >= 128.
// * N <= 8, ragged D or unaligned operands: mma.sync m16n8k32 s8·s8 -> s32
//   over a single shared-memory buffer. A CTA stages a BM x 128-byte chunk
//   of block rows and the matching 3·BC x 128-byte chunk of plane rows with
//   16-byte loads (byte loads for ragged D; rows padded to 36 words, so the
//   fragment loads are conflict-free), and each warp accumulates an
//   (MT·16) x (NT·8) output tile for all three planes in registers. At N=1
//   it runs at about half its byte bound.
//
// Exactness: every dot is an exact integer (|d| <= D·128, far below 2^24 at
// the layout's sizes), so the int32 -> f32 conversions are exact, and the
// fold runs with explicit _rn intrinsics (the build also passes
// --fmad=false), in the reference's order. The result is bit-identical to
// the Pallas body and to the reference's XLA formulation.

#include <cuda_runtime.h>
#include <stdint.h>

#include "s8_engine.cuh"

namespace {

constexpr int DC_THREADS = 256;
constexpr int DC_BK = 128;            // k (bytes) per shared-memory chunk
constexpr int DC_K4 = DC_BK / 4;      // int32 words per chunk row
constexpr int DC_STRIDE = DC_K4 + 4;  // 36 words: conflict-free fragments

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], int b0,
                                       int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage rows [0, n_rows) of a chunk: smem row i <- bytes [k0, k0+128) of
// global row src_row(i) (or zeros where src_row(i) < 0 or past D).
template <int N_ROWS, typename RowFn>
__device__ __forceinline__ void stage(int32_t (*dst)[DC_STRIDE],
                                      const int8_t* __restrict__ base, int D,
                                      int k0, int vec, RowFn src_row) {
  const int tid = threadIdx.x;
  if (vec) {  // D % 16 == 0 and 16-byte aligned bases: int4 loads
    for (int q = tid; q < N_ROWS * (DC_BK / 16); q += DC_THREADS) {
      const int row = q / (DC_BK / 16);
      const int k16 = q - row * (DC_BK / 16);
      const int k = k0 + 16 * k16;
      const long long g = src_row(row);
      int4 v = make_int4(0, 0, 0, 0);
      if (g >= 0 && k < D) {
        v = *reinterpret_cast<const int4*>(base + (size_t)g * D + k);
      }
      *reinterpret_cast<int4*>(&dst[row][4 * k16]) = v;
    }
  } else {  // ragged D: byte loads, zero past the edge
    for (int q = tid; q < N_ROWS * DC_K4; q += DC_THREADS) {
      const int row = q / DC_K4;
      const int k4 = q - row * DC_K4;
      const long long g = src_row(row);
      uint32_t v = 0;
      if (g >= 0) {
        const int8_t* src = base + (size_t)g * D;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = k0 + 4 * k4 + j;
          if (k < D) v |= (uint32_t)(uint8_t)src[k] << (8 * j);
        }
      }
      dst[row][k4] = (int32_t)v;
    }
  }
}

// 8 warps as WARPS_M x WARPS_N; warp tile MT m16-tiles x NT n8-tiles.
template <int WARPS_M, int WARPS_N, int MT, int NT>
__global__ void __launch_bounds__(DC_THREADS)
densecols_kernel(const int8_t* __restrict__ block,  // [nrow, D]
                 const int8_t* __restrict__ q3t,    // [3N, D]
                 const float* __restrict__ s,       // [N]
                 float* __restrict__ out,           // [nrow, N]
                 int nrow, int D, int N, int n_col_blocks, int vec) {
  static_assert(WARPS_M * WARPS_N * 32 == DC_THREADS, "8 warps");
  constexpr int BM = WARPS_M * MT * 16;
  constexpr int BC = WARPS_N * NT * 8;
  __shared__ __align__(16) int32_t As[BM][DC_STRIDE];
  __shared__ __align__(16) int32_t Xs[3 * BC][DC_STRIDE];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int wm = warp % WARPS_M;
  const int wn = warp / WARPS_M;
  const int cb = blockIdx.x % n_col_blocks;
  const int rb = blockIdx.x / n_col_blocks;
  const int r0 = rb * BM;
  const int c0 = cb * BC;

  int acc[MT][NT][3][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][p][e] = 0;

  for (int k0 = 0; k0 < D; k0 += DC_BK) {
    __syncthreads();  // the previous chunk is fully consumed
    stage<BM>(As, block, D, k0, vec, [&](int row) -> long long {
      const int r = r0 + row;
      return r < nrow ? r : -1;
    });
    stage<3 * BC>(Xs, q3t, D, k0, vec, [&](int row) -> long long {
      const int p = row / BC;
      const int c = c0 + (row - p * BC);
      return c < N ? (long long)p * N + c : -1;
    });
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < DC_K4; kw += 8) {  // 32 bytes of k per mma
      int a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = (wm * MT + i) * 16 + g;
        a[i][0] = As[r][kw + t];
        a[i][1] = As[r + 8][kw + t];
        a[i][2] = As[r][kw + 4 + t];
        a[i][3] = As[r + 8][kw + 4 + t];
      }
#pragma unroll
      for (int p = 0; p < 3; ++p) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = p * BC + (wn * NT + j) * 8 + g;
          const int b0 = Xs[n][kw + t];
          const int b1 = Xs[n][kw + 4 + t];
#pragma unroll
          for (int i = 0; i < MT; ++i) mma_s8(acc[i][j][p], a[i], b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = c0 + (wn * NT + j) * 8 + 2 * t + (e & 1);
      if (col >= N) continue;
      const float sc = s[col];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = r0 + (wm * MT + i) * 16 + g + (e >= 2 ? 8 : 0);
        if (r >= nrow) continue;
        const float hi = __fmul_rn(__int2float_rn(acc[i][j][0][e]), 65536.0f);
        const float mid = __fmul_rn(__int2float_rn(acc[i][j][1][e]), 256.0f);
        const float lo = __int2float_rn(acc[i][j][2][e]);
        out[(size_t)r * N + col] =
            __fmul_rn(__fadd_rn(__fadd_rn(hi, mid), lo), sc);
      }
    }
  }
}

template <int WARPS_M, int WARPS_N, int MT, int NT>
void launch(const int8_t* block, const int8_t* q3t, const float* s,
            float* out, int nrow, int D, int N, int vec, cudaStream_t stream) {
  constexpr int BM = WARPS_M * MT * 16;
  constexpr int BC = WARPS_N * NT * 8;
  const int ncb = (N + BC - 1) / BC;
  const int nrb = (nrow + BM - 1) / BM;
  densecols_kernel<WARPS_M, WARPS_N, MT, NT>
      <<<(unsigned int)ncb * nrb, DC_THREADS, 0, stream>>>(
          block, q3t, s, out, nrow, D, N, ncb, vec);
}

}  // namespace

extern "C" {

// vec: 1 when D % 16 == 0 and block and q3t are 16-byte aligned.
int fs_densecols(const int8_t* block, const int8_t* q3t, const float* s,
                 float* out, int nrow, int D, int N, int vec, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nrow > 0 && N > 0) {
    if (N >= 9 && vec && D > 0) {  // the s8 tensor-core engine
      s8e::Params p{};
      p.items = s8e::ITEMS_DENSE;
      p.scale = s;
      p.out = out;
      p.nwg = 2;
      p.n_col_blocks = (N + 63) / 64;
      p.k_chunks = (D + s8e::KC - 1) / s8e::KC;
      p.grp = N;  // plane q of column c is q3t row c + q·N
      p.n_out = N;
      p.out_rows = nrow;
      return s8e::launch<64, 3>(block, nrow, D, q3t, 3LL * N, D, p,
                                (nrow + 127) / 128, st);
    }
    if (N <= 8) {  // 128 x 8 tile: the block streams once
      launch<8, 1, 1, 1>(block, q3t, s, out, nrow, D, N, vec, st);
    } else {  // 64 x 64 (ragged D or unaligned operands only)
      launch<4, 2, 1, 4>(block, q3t, s, out, nrow, D, N, vec, st);
    }
  }
  return (int)cudaGetLastError();
}

// Dynamic shared memory and ring depth the engine asks for with BN-row
// plane boxes, `planes` planes and nwg consumer warpgroups.
int fs_s8_engine_smem(int bn, int planes, int nwg, int* stages) {
  *stages = s8e::ring_stages(bn, planes, nwg);
  return s8e::ring_bytes(bn, planes, nwg);
}

}  // extern "C"
