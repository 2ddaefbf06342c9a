// The s8 tensor-core engine for Hopper (sm_90a): one body for the three
// int8 products of the port, kernel #7 (densecols_spmm.cu, the CUDA
// counterpart of densecols_spmm_pallas), kernel #3 in its "i8w" and narrow
// int8 modes and kernel #4 in its halo narrow mode (bsr_spmm.cu, the
// counterparts of mono_panel_spmm and mono_group_spmm), all in
// fastsparse/ops/pallas/bsr_spmm.py.
//
//   Y[r, c] = fold_p( Σ_k A[r, k]·B[lane_p(c), k] )   (exact s32 dots)
//
// A (block rows or panel rows) and B (X planes) are int8 and K-major: each
// row holds consecutive k. An output tile is 64·nwg rows (nwg consumer
// warpgroups, 64 rows each: the wgmma M) by BN output columns, with a list
// of items: one for densecols (the whole k range of its row block), the
// strip's panel items in ascending order for mono_panel, the strip's one
// item for the halo layout. Each item is a k loop in 128-byte chunks. Each
// output element is written once, by its tile.
//
// Persistent grid: one CTA per SM (its registers leave room for no other)
// walks the tiles round robin, and the ring runs on across tiles, so one
// tile's fold and stores overlap the next tile's first loads (a mono tile
// is only a few chunks long).
//
// Pipeline: a ring of `stages` chunks in dynamic shared memory. Each stage
// holds an A box per warpgroup (64 rows x 128 B) and P boxes of B (BN rows
// x 128 B, one per plane: P = 3 radix planes, or 1 for raw narrow lanes),
// all loaded by TMA (cp.async.bulk.tensor) with the 128-byte swizzle and
// counted on the stage's `full` mbarrier. One producer warp (one elected
// thread) keeps the ring full; the consumer warpgroups wait on `full`, issue
// four wgmma.mma_async m64n(P·BN)k32 s8·s8->s32 per chunk (both operands
// K-major from shared memory, which is the only form s8 wgmma takes), wait
// for them and release the stage on its `empty` mbarrier (one arrival per
// consumer warp).
//
// Epilogue: after an item's last chunk each thread folds its accumulators.
// P = 3: the three plane dots of one (row, column) sit in the same thread
// (accumulator q of plane p is register q + p·BN/2), folded as
// ((f32(d0)·65536 + f32(d1)·256) + f32(d2))·s[c] with explicit _rn
// intrinsics (the build also passes --fmad=false); P = 1: f32(d). The
// item's value sets the f32 result on the strip's first item and is added
// by __fadd_rn on the later ones, in item order: the reference's order, so
// the output is bit-equal to the plain versions (every dot is an exact
// integer far below 2^24). Rows and columns past the output are not stored.
//
// Bound on this card: int8 multiply-adds from N of a few dozen on (the
// ECFP block at N=128: 0.105 ms of operations against 0.081 of bytes at
// 1,979 TOP/s and 3.35 TB/s). The tensor cores take every MAC; TMA and the
// mbarrier ring overlap the loads with them and leave no register or
// instruction of the consumers to addressing.
//
// Host side: cuTensorMapEncodeTiled lives in libcuda, which the library is
// not linked against, so its entry point is fetched through the runtime
// (cudaGetDriverEntryPointByVersion). The maps are passed by value as
// __grid_constant__ parameters. TMA needs 16-byte global row pitches and
// 16-byte aligned bases: the launchers only route such shapes here. A
// failed encode or a shared-memory size the card cannot give returns an
// error code before any launch; nothing falls back to another body.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "async_copy.cuh"

// The engine lives in an unnamed namespace: each source that includes it
// gets its own copy, with no symbol shared at link time.
namespace {
namespace s8e {

constexpr int KC = 128;                // k bytes per chunk: one swizzle row
constexpr int WG_ROWS = 64;            // A rows per consumer warpgroup
constexpr int A_BOX = WG_ROWS * KC;    // bytes of one A box
constexpr int MAX_STAGES = 6;
constexpr int SMEM_LIMIT = 232448;     // opt-in shared memory per block
constexpr int ERR_SHAPE = -1;          // a shape the engine does not take
constexpr int ERR_ENCODE = -2;         // cuTensorMapEncodeTiled refused
constexpr int ERR_SMEM = -3;           // the ring does not fit

// Where a tile's items come from.
enum Items : int {
  ITEMS_DENSE = 0,  // one item, the tile's own rows (densecols)
  ITEMS_PANEL = 1,  // strip s: items [strip_ptr[s], strip_ptr[s+1])
  ITEMS_HALO = 2,   // strip s: item s alone (the halo layout)
};

struct Params {
  int items;           // Items
  // mono item i: A rows from i·TM, B k from
  // (window[i / group]·win_stride + start_rel[i])·TK (group 1 for panels)
  const int32_t* window;
  const int32_t* strip_ptr;  // ITEMS_PANEL only
  const int32_t* start_rel;
  const float* scale;  // per output column (P == 3)
  float* out;          // [out_rows, n_out] f32
  int nwg;             // consumer warpgroups: 64·nwg rows per CTA
  int stages;          // ring depth (set by launch())
  int n_tiles;         // output tiles: row tiles x column blocks
  int n_row_blocks;    // row tiles per mono strip
  int n_col_blocks;    // column blocks of BN output columns
  int TM, TK, win_stride, group;
  int k_chunks;        // 128-byte chunks per item
  int grp;             // B lane of plane p, column c:
                       // (c / grp)·3·grp + c % grp + p·grp
  int n_out;           // output columns (the row pitch of out)
  int out_rows;        // output rows that exist
};

using acp::mbar_arrive;
using acp::mbar_expect_tx;
using acp::mbar_init;
using acp::mbar_wait;
using acp::smem_u32;

// One 2-D TMA box: coordinates (k, row), innermost first.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k),
      "r"(row)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 B, 8-row groups 1024 B apart (SBO); LBO unused (1).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (it does not know the registers change behind it).
template <int R>
__device__ __forceinline__ void pin(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma.mma_async m64nNk32 s32 += s8·s8, A and B from shared memory
// (K-major descriptors); acc == 0 overwrites the accumulators.
__device__ __forceinline__ void wgmma_n32(int (&d)[16], uint64_t da,
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da,
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_n96(int (&d)[48], uint64_t da,
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da,
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_n192(int (&d)[96], uint64_t da,
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(da), "l"(db), "r"(acc));
}

template <int N>
__device__ __forceinline__ void wgmma(int (&d)[N / 2], uint64_t da,
                                      uint64_t db, int acc) {
  if constexpr (N == 32) {
    wgmma_n32(d, da, db, acc);
  } else if constexpr (N == 64) {
    wgmma_n64(d, da, db, acc);
  } else if constexpr (N == 96) {
    wgmma_n96(d, da, db, acc);
  } else if constexpr (N == 128) {
    wgmma_n128(d, da, db, acc);
  } else {
    static_assert(N == 192, "wgmma widths of the engine");
    wgmma_n192(d, da, db, acc);
  }
}

// One output tile: column block cb (BN columns from c0) of row tile t
// (densecols: a row block; mono: one 64·nwg-row part h of a strip), its
// items [begin, end) and its first output row. Kept branch-shaped with one
// exit: with an early return, nvcc rebuilt the scale pointer for every
// load of the n192 epilogue (densecols N=256 ~12 % slower on an H100).
struct Tile {
  int c0, begin, end, h, out_row0;
};

__device__ __forceinline__ Tile tile_of(const Params& p, int t, int bn,
                                        int rows_cta) {
  Tile tl;
  const int cb = t % p.n_col_blocks;
  const int rt = t / p.n_col_blocks;
  tl.c0 = cb * bn;
  tl.h = 0;
  if (p.items != ITEMS_DENSE) {
    const int strip = rt / p.n_row_blocks;
    tl.h = rt - strip * p.n_row_blocks;
    const bool panel = p.items == ITEMS_PANEL;
    tl.begin = panel ? p.strip_ptr[strip] : strip;
    tl.end = panel ? p.strip_ptr[strip + 1] : strip + 1;
    tl.out_row0 = strip * p.TM + tl.h * rows_cta;
  } else {
    tl.begin = 0;
    tl.end = 1;
    tl.out_row0 = rt * rows_cta;
  }
  return tl;
}

// Threads: 128·nwg consumers (warpgroups first, as wgmma wants them
// aligned), then one producer warp. Persistent: CTA b takes tiles b,
// b + gridDim.x, ... (the column blocks of one row tile stay neighbours,
// so they run together and share the A rows through L2), and the ring
// runs on across tiles, so a tile's epilogue overlaps the next one's loads.
template <int BN, int P>
__global__ void __launch_bounds__(2 * 128 + 32, 1)
s8_engine_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b, const Params p) {
  constexpr int NACC = P * BN / 2;  // s32 accumulators per thread
  constexpr int NRES = BN / 2;      // f32 outputs per thread
  constexpr int B_BOX = BN * KC;
  extern __shared__ uint8_t smem_raw[];
  // stage bases on 1024-byte boundaries (the swizzle atom)
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int a_bytes = p.nwg * A_BOX;
  const int stage_bytes = a_bytes + P * B_BOX;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.stages * stage_bytes);
  uint64_t* empty = full + p.stages;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_cons_warps = 4 * p.nwg;
  const int rows_cta = WG_ROWS * p.nwg;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], n_cons_warps);
    }
    acp::fence_mbar_init();
  }
  __syncthreads();

  int stage = 0;
  uint32_t phase = 0;
  if (warp == n_cons_warps) {
    // ------------------------------------------------------- producer
    if (lane != 0) return;
    for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
      const Tile tl = tile_of(p, t, BN, rows_cta);
      const int lane0 = (tl.c0 / p.grp) * 3 * p.grp + tl.c0 % p.grp;
      for (int it = tl.begin; it < tl.end; ++it) {
        int a_row = tl.out_row0, b_k = 0;
        if (p.items != ITEMS_DENSE) {
          a_row = it * p.TM + tl.h * rows_cta;
          b_k = (p.window[it / p.group] * p.win_stride + p.start_rel[it]) *
                p.TK;
        }
        for (int kc = 0; kc < p.k_chunks; ++kc) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* st = smem + stage * stage_bytes;
          mbar_expect_tx(&full[stage], stage_bytes);
          for (int w = 0; w < p.nwg; ++w) {
            tma_load(st + w * A_BOX, &map_a, &full[stage], kc * KC,
                     a_row + w * WG_ROWS);
          }
#pragma unroll
          for (int q = 0; q < P; ++q) {
            tma_load(st + a_bytes + q * B_BOX, &map_b, &full[stage],
                     b_k + kc * KC, lane0 + q * p.grp);
          }
          if (++stage == p.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }
  // -------------------------------------------------------- consumers
  const int wg = warp / 4;
  const int row_in = wg * WG_ROWS + 16 * (warp & 3) + (lane >> 2);
  int acc[NACC];
#pragma unroll
  for (int q = 0; q < NACC; ++q) acc[q] = 0;
  for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
    const Tile tl = tile_of(p, t, BN, rows_cta);
    float res[NRES];
#pragma unroll
    for (int q = 0; q < NRES; ++q) res[q] = 0.0f;
    for (int it = tl.begin; it < tl.end; ++it) {
      for (int kc = 0; kc < p.k_chunks; ++kc) {
        mbar_wait(&full[stage], phase);
        const uint8_t* st = smem + stage * stage_bytes;
        const uint64_t da = sw128_desc(st + wg * A_BOX);
        const uint64_t db = sw128_desc(st + a_bytes);
        pin(acc);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < KC / 32; ++ks) {  // +32 bytes of k: +2 units
          wgmma<P * BN>(acc, da + 2 * ks, db + 2 * ks, (kc | ks) != 0);
        }
        wg_commit();
        wg_wait_all();
        pin(acc);
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      // accumulator q: column 8·(q/4) + 2·(lane%4) + q%2 of the plane,
      // row 16·(warp%4) + lane/4 + 8·((q/2)%2) of the warpgroup's 64
#pragma unroll
      for (int q = 0; q < NRES; ++q) {
        float v;
        if constexpr (P == 3) {
          const int col = tl.c0 + 8 * (q >> 2) + 2 * (lane & 3) + (q & 1);
          const float sc = col < p.n_out ? __ldg(p.scale + col) : 0.0f;
          const float hi = __fmul_rn(__int2float_rn(acc[q]), 65536.0f);
          const float mid =
              __fmul_rn(__int2float_rn(acc[q + NRES]), 256.0f);
          const float lo = __int2float_rn(acc[q + 2 * NRES]);
          v = __fmul_rn(__fadd_rn(__fadd_rn(hi, mid), lo), sc);
        } else {
          v = __int2float_rn(acc[q]);
        }
        res[q] = (it == tl.begin) ? v : __fadd_rn(res[q], v);
      }
    }
#pragma unroll
    for (int q = 0; q < NRES; q += 2) {
      const int row = tl.out_row0 + row_in + 8 * ((q >> 1) & 1);
      const int col = tl.c0 + 8 * (q >> 2) + 2 * (lane & 3);
      if (row >= p.out_rows || col >= p.n_out) continue;
      float* o = p.out + static_cast<size_t>(row) * p.n_out + col;
      if ((p.n_out & 1) == 0) {  // col even: an aligned pair
        *reinterpret_cast<float2*>(o) = make_float2(res[q], res[q + 1]);
      } else {
        o[0] = res[q];
        if (col + 1 < p.n_out) o[1] = res[q + 1];
      }
    }
  }
}

// ------------------------------------------------------------------ host
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

inline EncodeFn encode_fn() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeFn>(ptr);
  }
  return fn;
}

// Map of a row-major int8 matrix [rows, cols] read in boxes of box_rows
// rows x 128 bytes with the 128-byte swizzle; zeros outside the matrix.
inline int encode(CUtensorMap* map, const void* base, long long rows,
                  long long cols, int box_rows) {
  const EncodeFn fn = encode_fn();
  if (fn == nullptr || rows <= 0 || cols <= 0 || cols % 16 != 0 ||
      reinterpret_cast<uintptr_t>(base) % 16 != 0) {
    return ERR_ENCODE;
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(KC),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

// Ring depth and dynamic shared memory of a launch (0 stages: no fit).
inline int ring_stages(int bn, int planes, int nwg) {
  const int stage_bytes = nwg * A_BOX + planes * bn * KC;
  const int s = (SMEM_LIMIT - 1024 - 16 * MAX_STAGES) / stage_bytes;
  return s < MAX_STAGES ? s : MAX_STAGES;
}
inline int ring_bytes(int bn, int planes, int nwg) {
  const int stages = ring_stages(bn, planes, nwg);
  return 1024 + stages * (nwg * A_BOX + planes * bn * KC) + 16 * stages;
}

// A: [a_rows, a_cols], B: [b_rows, b_cols] int8, both K-major; row_tiles
// row tiles (strips x row blocks, or row blocks) x p.n_col_blocks output
// tiles, walked by one CTA per SM (at most one fits: registers).
template <int BN, int P>
int launch(const void* a, long long a_rows, long long a_cols, const void* b,
           long long b_rows, long long b_cols, Params p, long long row_tiles,
           cudaStream_t stream) {
  CUtensorMap ma, mb;
  if (encode(&ma, a, a_rows, a_cols, WG_ROWS) != 0 ||
      encode(&mb, b, b_rows, b_cols, BN) != 0) {
    return ERR_ENCODE;
  }
  p.stages = ring_stages(BN, P, p.nwg);
  const int smem = ring_bytes(BN, P, p.nwg);
  if (p.stages < 2 || smem > SMEM_LIMIT) return ERR_SMEM;
  const long long n_tiles = row_tiles * p.n_col_blocks;
  if (n_tiles > INT_MAX) return ERR_SHAPE;
  if (n_tiles <= 0) return 0;
  p.n_tiles = static_cast<int>(n_tiles);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  auto kern = s8_engine_kernel<BN, P>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = p.n_tiles < sms ? p.n_tiles : sms;
  kern<<<grid, p.nwg * 128 + 32, smem, stream>>>(ma, mb, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace s8e
}  // namespace
