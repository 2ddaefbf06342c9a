"""SpMV ``y = A @ x`` and ``y = A.T @ x`` (counterpart of
``fastsparse/ops/spmv.py``).

Ported: the BsrMatrix branch (the `bucket_spmv` kernel for tile buckets,
a one-column product for panel layouts), the ColSegmented branch (the
cross-segment product, else each segment's own SpMV, as the reference
dispatches), the f32 EllMatrix / SegmentedEll branches and the
HybridMatrix branch. The reference runs f32 ELL SpMV through
the gather SpMM kernel on its accelerator (one gathered row per nonzero
costs the same at N=1); the port takes that dispatch on every device: the
CUDA kernels on a CUDA tensor, their plain versions on a CPU tensor; an
f64 SpMV on the card runs the table kernel's f64 mode
(`ell_ops.gather_engine_supported`). ELL of other dtypes, f64 on the CPU,
or past the engine's residency budget, runs the reference's per-bucket
gather, row sum and ``index_add_`` as torch ops (span ``ell_scan``).
COO/CSR (valued or binary) and `spmv_t` (COO/CSR, EllMatrix,
SegmentedEll; the tiled formats refuse it, as in the reference) run the
scatter engine of `ops.spmm` on one column.
"""
from __future__ import annotations

import torch

from .. import tracing
from ..formats.bsr import BsrMatrix
from ..formats.ell import EllMatrix, SegmentedEll
from ..formats.hybrid import HybridMatrix
from ..formats.segmented import ColSegmented
from .spmm import (
    _bucket_cols, _coo_like, _ell_dtype, _stream_scatter, dense_cols_spmm,
    spmm_t,
)

__all__ = ["spmv", "spmv_t"]


def spmv(A, x):
    """``y = A @ x``. ``x``: dtype[ncol] -> dtype[nrow]."""
    if isinstance(A, HybridMatrix):
        with tracing.span("hybrid"):
            return _hybrid_spmv(A, x)
    if isinstance(A, ColSegmented):
        from .bsr_ops import colseg_spmm

        y = colseg_spmm(A, x[:, None])
        if y is not None:
            return y[:, 0]
        y = torch.zeros((A.shape[0],), dtype=x.dtype, device=x.device)
        tracing.count(1 + len(A.segments))
        for off, seg in zip(A.col_offsets, A.segments):
            y = y + spmv(seg, x[off : off + seg.shape[1]])
        return y
    if isinstance(A, BsrMatrix):
        from .bsr_ops import bsr_spmv

        return bsr_spmv(A, x)
    if isinstance(A, (EllMatrix, SegmentedEll)):
        from .ell_ops import ell_spmm, gather_engine_fits, gather_engine_supported

        seg_ncol = A.seg_cols if isinstance(A, SegmentedEll) else A.shape[1]
        dt = _ell_dtype(A, x)
        if (gather_engine_supported(dt, A, x[:, None])
                and gather_engine_fits(seg_ncol, 1)):
            return ell_spmm(A, x[:, None])[:, 0]
        with tracing.span("ell_scan", dtype=str(dt).removeprefix("torch.")):
            return _ell_scan_spmv(A, x, dt)
    rows, cols, vals = _coo_like(A)
    return _stream_scatter(rows, cols, vals, x[:, None], A.shape[0])[:, 0]


def _ell_scan_spmv(A, x, dt):
    """The reference's per-bucket SpMV as torch ops: each bucket's row sums
    added into y at their row ids, a SegmentedEll's segments added in
    segment order (counter ``ell_scan``: one per bucket)."""
    if isinstance(A, SegmentedEll):
        y = torch.zeros((A.shape[0],), dtype=x.dtype, device=x.device)
        tracing.count(1 + len(A.segments))
        for off, seg in zip(A.col_offsets, A.segments):
            y = y + _ell_scan_spmv(seg, x[off : off + seg.shape[1]], dt)
        return y
    tracing.count(1 + (x.dtype != dt))
    x = x.to(dt)
    y = torch.zeros((A.shape[0],), dtype=dt, device=x.device)
    for b in A.buckets:
        tracing.count(7 + (b.vals.dtype != dt))
        tracing.count(1, "ell_scan")
        contrib = (b.vals.to(dt) * x[_bucket_cols(b, A.shape[1])]).sum(1)
        y.index_add_(0, b.row_ids.long(), contrib)
    return y


def _hybrid_spmv(A, x):
    y = torch.zeros((A.shape[0],), dtype=x.dtype, device=x.device)
    tracing.count()
    if A.dense is not None:
        tracing.count()
        y = y + spmv(A.dense, x)
    if A.sparse is not None:
        tracing.count()
        y = y + spmv(A.sparse, x)
    if A.dense_cols is not None:
        tracing.count()
        y = y + dense_cols_spmm(A.dense_cols, x[:, None])[:, 0]
    return y


def spmv_t(A, x):
    """``y = A.T @ x``. ``x``: dtype[nrow] -> dtype[ncol]: `spmm_t` on one
    column (the scatter engine; prefer the transpose tiling,
    `operator(..., transpose=True)`, on a hot path)."""
    return spmm_t(A, x[:, None])[:, 0]
