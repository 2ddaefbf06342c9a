// Hand-written Hopper (sm_90a) kernels for the fp64-class ELL gather: the
// CUDA counterparts of two Pallas TPU kernels in
// fastsparse/ops/pallas/ell_spmm.py.
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
// Design: the TPU kernel carries (hi, lo) across an in-order ("arbitrary")
// grid axis over the row's K slots. Here one thread owns one (bucket row,
// lane), walks the row's slots in order with (hi, lo) in registers, and
// writes each output once. The chain is serial, so a bucket of a few long
// rows (up to 2,048 slots at N = 1) keeps one warp busy for its whole
// length while the rest of the card idles; one launch per bucket adds the
// buckets' chains up (PERF.md). Lanes go fastest within a warp: a row's
// lanes split over TPR = min(32, next_pow2(N)) threads, so at N >= 32 a
// warp reads 32 consecutive floats of each gathered X row, and at N = 1 a
// warp covers 32 rows. The row's columns
// (and value planes) are read once per slot; the lanes of a row read the
// same address, a broadcast.
//
// Bound on this card: bytes. #12 reads 4 B of index per slot, #13 12 B
// (index, vh, vl), plus each gathered X row in both planes and each output
// written once (hi and lo). #12 does 8 f32 operations per slot and lane,
// #13 25 (plus 4 per slot for the split of vh); against 67 TFLOP/s that is
// below the time of the bytes at 3.35 TB/s at the main path's shapes.
// The gathered rows are scattered, so they come through L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DD_THREADS = 256;

// Dekker split at 4097 (12/12 bits): hi + lo == a exactly
__device__ __forceinline__ void split4097(float a, float& hi, float& lo) {
  const float c = __fmul_rn(a, 4097.0f);
  hi = __fsub_rn(c, __fsub_rn(c, a));
  lo = __fsub_rn(a, hi);
}

// One slot's step of the row's (hi, lo) chain, in the reference's order.
template <bool VALUED>
__device__ __forceinline__ void dd_step(float& hi, float& lo, float xh,
                                        float xl, float v_h, float v_l) {
  if constexpr (VALUED) {
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
    // branch-free TwoSum(hi, p1); residue + cross into the low word
    const float s = __fadd_rn(hi, p1);
    const float bb = __fsub_rn(s, hi);
    const float e =
        __fadd_rn(__fsub_rn(hi, __fsub_rn(s, bb)), __fsub_rn(p1, bb));
    hi = s;
    lo = __fadd_rn(lo, __fadd_rn(e, __fadd_rn(perr, cross)));
  } else {
    // TwoSum(hi, xh) -> (s, err); err and xl into the low word
    const float s = __fadd_rn(hi, xh);
    const float bb = __fsub_rn(s, hi);
    const float err =
        __fadd_rn(__fsub_rn(hi, __fsub_rn(s, bb)), __fsub_rn(xh, bb));
    hi = s;
    lo = __fadd_rn(lo, __fadd_rn(err, xl));
  }
}

template <bool VALUED>
__global__ void __launch_bounds__(DD_THREADS)
ell_dd_kernel(const int32_t* __restrict__ cols, const float* __restrict__ vh,
              const float* __restrict__ vl, const float* __restrict__ x2,
              float* __restrict__ out_hi, float* __restrict__ out_lo, int nb,
              int K, int k_rows, int ldx, int tpr_log2) {
  const int tpr = 1 << tpr_log2;
  const int r = blockIdx.x * (DD_THREADS >> tpr_log2) + (threadIdx.x >> tpr_log2);
  const int lane = blockIdx.y * tpr + (threadIdx.x & (tpr - 1));
  if (r >= nb || lane >= ldx) return;
  const size_t row0 = (size_t)r * K;
  const size_t lo_plane = (size_t)k_rows * ldx;
  float hi = 0.0f, lo = 0.0f;
  for (int k = 0; k < K; ++k) {
    const size_t xo = (size_t)__ldg(cols + row0 + k) * ldx + lane;
    dd_step<VALUED>(hi, lo, __ldg(x2 + xo), __ldg(x2 + lo_plane + xo),
                    VALUED ? __ldg(vh + row0 + k) : 0.0f,
                    VALUED ? __ldg(vl + row0 + k) : 0.0f);
  }
  out_hi[(size_t)r * ldx + lane] = hi;
  out_lo[(size_t)r * ldx + lane] = lo;
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
    const int rows_per_block = DD_THREADS >> tpr_log2;
    const int n_lane_blocks = (ldx + (1 << tpr_log2) - 1) >> tpr_log2;
    if (n_lane_blocks > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid((nb + rows_per_block - 1) / rows_per_block, n_lane_blocks);
    const cudaStream_t st = (cudaStream_t)stream;
    if (valued) {
      ell_dd_kernel<true><<<grid, DD_THREADS, 0, st>>>(
          cols, vh, vl, x2, out_hi, out_lo, nb, K, k_rows, ldx, tpr_log2);
    } else {
      ell_dd_kernel<false><<<grid, DD_THREADS, 0, st>>>(
          cols, vh, vl, x2, out_hi, out_lo, nb, K, k_rows, ldx, tpr_log2);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
