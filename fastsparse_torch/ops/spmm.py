"""Multi-RHS SpMM ``Y = A @ X`` and ``Y = A.T @ X`` (counterpart of
``fastsparse/ops/spmm.py``).

Ported: the BsrMatrix branch (mono, class panels, tile buckets), the
ColSegmented branch (one cross-segment plan, else the sum of the segments'
products, as the reference dispatches), the EllMatrix / SegmentedEll
branches (the f32 gather engine, and on the card its table kernel's f64
mode at X widths of at most 8; for other dtypes and widths, f64 on the
CPU, or an unsegmented X panel past the engine's residency budget, the
reference's per-bucket scan as torch ops, span ``ell_scan``), the
HybridMatrix branch with its dense tiles and its
dense-column block (`dense_cols_spmm`, the `densecols_spmm` kernel),
`spmm_dd`, the fp64-class product, and the reference's streaming scatter
engine for COO/CSR (`_stream_scatter`), which `spmm_t` also runs down the
columns of COO/CSR and ELL (`ops.spmv` runs both on one column). The
scatter adds with ``index_add_``: on a CUDA tensor, atomics in no fixed
order, so those products match the reference within tolerance, not bit
for bit. Sums of f32 products accumulate in float64 (`_acc_dtype`) and
round once: an f32 sum in arbitrary order over the ~1,900 entries of
BASELINE config 2's longest row or column drifts to about 1e-6 of
max|y|, the bar itself (a numpy replay of that matrix's heaviest rows).
"""
from __future__ import annotations

import torch

from .. import tracing
from ..formats.bsr import BsrMatrix
from ..formats.coo import COO, BinaryCOO
from ..formats.csr import CSR, BinaryCSR
from ..formats.ell import EllMatrix, SegmentedEll
from ..formats.hybrid import HybridMatrix
from ..formats.segmented import ColSegmented

__all__ = ["spmm", "spmm_t", "spmm_dd", "dense_cols_spmm",
           "densecols_planes"]

# bytes of the gathered (chunk, N) intermediate per scatter step: at N=128
# an f32 product on 4M nonzeros would otherwise gather 2 GB at once
_CHUNK_BYTES = 256 * 1024 * 1024


def _acc_dtype(dt):
    """The scatter's accumulation dtype for products of dtype ``dt``."""
    return torch.float64 if dt in (torch.float32, torch.bfloat16,
                                   torch.float16) else dt


def _coo_like(mat):
    """(rows, cols, vals) of a COO/CSR's live entries, vals None for binary
    matrices. Padding is trailing by definition (``valid_mask`` is ``k <
    n_valid``), so the engines skip it where the reference masks it: the
    same sums, without the padding's atomics on row 0."""
    n = mat.n_valid
    if isinstance(mat, (COO, CSR)):
        return mat.rows[:n], mat.cols[:n], mat.vals[:n]
    if isinstance(mat, (BinaryCOO, BinaryCSR)):
        return mat.rows[:n], mat.cols[:n], None
    raise TypeError(f"unsupported format {type(mat).__name__}")


def _scatter_add(acc, tgt, src, vals, X):
    """``acc[tgt[k]] += vals[k]·X[src[k]]`` (unit values when None; each
    product in X's dtype, added in acc's), in chunks whose gathered rows
    stay within ``_CHUNK_BYTES`` (the reference scans fixed chunks of
    32,768 entries, a static shape for ``lax.scan``; the sum is the
    same)."""
    n = int(tgt.shape[0])
    step = max(1, _CHUNK_BYTES // max(X.shape[1] * 8, 1))
    for k0 in range(0, n, step):
        k1 = min(k0 + step, n)
        g = X[src[k0:k1].long()]
        if vals is not None:
            g = vals[k0:k1, None] * g
        acc.index_add_(0, tgt[k0:k1].long(), g.to(acc.dtype))
    return acc


def _stream_scatter(rows, cols, vals, X, n_out):
    """``Y[n_out, N]``, ``Y[rows[k]] += vals[k]·X[cols[k]]`` (binary: vals
    None), in the promoted dtype of the values and ``X``."""
    dt = X.dtype if vals is None else torch.promote_types(vals.dtype, X.dtype)
    acc = torch.zeros((n_out, X.shape[1]), dtype=_acc_dtype(dt),
                      device=X.device)
    return _scatter_add(acc, rows, cols, None if vals is None else vals.to(dt),
                        X.to(dt)).to(dt)


def _ell_dtype(A, X):
    return torch.promote_types(A.dtype, X.dtype)


def _bucket_cols(b, ncol):
    """A bucket's columns as gather indices: the binary sentinel ``ncol``
    (zero values) clamped onto the last column, as XLA clamps an
    out-of-range gather."""
    return b.cols.long().clamp(max=max(ncol - 1, 0))


def _ell_scan(A, X):
    """The reference's per-bucket scan (`ops/spmm.py`, EllMatrix branch):
    each bucket's rows summed slot by slot in slot order, the bucket's
    rows then added into Y at their row ids; a SegmentedEll's segments
    added in segment order. Span ``ell_scan``, counter ``ell_scan``: one
    per bucket."""
    dt = _ell_dtype(A, X)
    with tracing.span("ell_scan", dtype=str(dt).removeprefix("torch.")):
        if isinstance(A, EllMatrix):
            return _scan_buckets(A, X, dt)
        Y = torch.zeros((A.shape[0], X.shape[1]), dtype=dt, device=X.device)
        tracing.count(1 + len(A.segments))
        for off, seg in zip(A.col_offsets, A.segments):
            Y = Y + _scan_buckets(seg, X[off : off + seg.shape[1]], dt)
        return Y


def _scan_buckets(A, X, dt):
    tracing.count(1 + (X.dtype != dt))
    X = X.to(dt)
    Y = torch.zeros((A.shape[0], X.shape[1]), dtype=dt, device=X.device)
    for b in A.buckets:
        K = b.cols.shape[1]
        tracing.count(5 + 3 * K + (b.vals.dtype != dt))
        tracing.count(1, "ell_scan")
        cols = _bucket_cols(b, A.shape[1])
        vals = b.vals.to(dt)
        acc = torch.zeros((cols.shape[0], X.shape[1]), dtype=dt,
                          device=X.device)
        for k in range(K):
            acc = acc + vals[:, k, None] * X[cols[:, k]]
        Y.index_add_(0, b.row_ids.long(), acc)
    return Y


def densecols_planes(X, col_ids):
    """f32 X and the int32 ``(D,)`` ids of its selected rows -> the
    densecols kernel's operands: the three radix-256 int8 planes of
    ``X[col_ids]`` as k-contiguous rows, int8 ``(3N, D)``
    (row ``p·N + n`` is plane ``p`` of column ``n``), and the f32 ``(1,
    N)`` scale. One `quant3_encode`: on the card a fill and two launches
    that gather the rows in place; elsewhere the torch ops the reference
    leaves to XLA (the gather, ``_quant3_carry``, the concatenation)."""
    from .kernels.bsr_spmm import quant3_encode

    return quant3_encode(X, col_ids, k_rows=col_ids.numel(),
                         n_pad=X.shape[1], n_out=3 * X.shape[1])


def dense_cols_spmm(dc, X):
    """``Y = block @ X[col_ids]`` for a `formats.hybrid.DenseCols`: f32
    ``(nrow, N)`` for an f32 ``X``, at fp32 parity.

    The selected rows are encoded as radix-256 int8 planes
    (`densecols_planes`) and the block is read once by the
    `densecols_spmm` kernel, at every N. The reference's bf16 branches
    (``precision="default"``, a non-f32 X, ``DENSECOLS_DOT = "bf16"``) are
    plain dots no caller of either package selects; they are not ported."""
    if X.dtype != torch.float32:
        raise NotImplementedError(
            f"dense_cols_spmm over {X.dtype}: only f32 (the int8-plane "
            "parity path) is ported"
        )
    from .kernels.bsr_spmm import densecols_spmm

    with tracing.span("densecols"):
        q3t, s = densecols_planes(X, dc.col_ids)
        return densecols_spmm(dc.block, q3t, s)[: dc.shape[0]]


def spmm(A, X):
    """``Y = A @ X``. ``X``: dtype[ncol, N] -> dtype[nrow, N]."""
    if isinstance(A, HybridMatrix):
        with tracing.span("hybrid"):
            return _hybrid_spmm(A, X)
    if isinstance(A, ColSegmented):
        from .bsr_ops import colseg_spmm

        Y = colseg_spmm(A, X)
        if Y is not None:
            return Y
        Y = torch.zeros((A.shape[0], X.shape[1]), dtype=X.dtype,
                        device=X.device)
        tracing.count(1 + len(A.segments))
        for off, seg in zip(A.col_offsets, A.segments):
            Y = Y + spmm(seg, X[off : off + seg.shape[1]])
        return Y
    if isinstance(A, BsrMatrix):
        from .bsr_ops import bsr_spmm

        return bsr_spmm(A, X)
    if isinstance(A, (EllMatrix, SegmentedEll)):
        from .ell_ops import ell_spmm, gather_engine_fits, gather_engine_supported

        fits = isinstance(A, SegmentedEll) or gather_engine_fits(
            A.shape[1], X.shape[1]
        )
        dt = _ell_dtype(A, X)
        if gather_engine_supported(dt, A, X) and fits:
            return ell_spmm(A, X)
        return _ell_scan(A, X)
    rows, cols, vals = _coo_like(A)
    return _stream_scatter(rows, cols, vals, X, A.shape[0])


def _hybrid_spmm(A, X):
    # the reference's order of adds: ((0 + dense) + sparse) + dense_cols
    Y = torch.zeros((A.shape[0], X.shape[1]), dtype=X.dtype, device=X.device)
    tracing.count()
    if A.dense is not None:
        tracing.count()
        Y = Y + spmm(A.dense, X)
    if A.sparse is not None:
        tracing.count()
        Y = Y + spmm(A.sparse, X)
    if A.dense_cols is not None:
        tracing.count()
        Y = Y + dense_cols_spmm(A.dense_cols, X)
    return Y


def spmm_t(A, X):
    """``Y = A.T @ X``. ``X``: dtype[nrow, N] -> dtype[ncol, N]. The
    scatter engine: prefer the transpose tiling on a hot path."""
    if isinstance(A, (BsrMatrix, ColSegmented, HybridMatrix)):
        raise TypeError(
            "tiled formats have no transpose-scatter path; build the dual "
            "tiling via fastsparse_torch.operator(..., transpose=True) "
            "instead"
        )
    if isinstance(A, SegmentedEll):
        Y = torch.zeros((A.shape[1], X.shape[1]), dtype=X.dtype,
                        device=X.device)
        for off, seg in zip(A.col_offsets, A.segments):
            Y[off : off + seg.shape[1]] += spmm_t(seg, X)
        return Y
    if isinstance(A, EllMatrix):
        # every bucket slot scatters its row of X to its column; one spare
        # row takes the binary sentinel column (ncol), which the
        # reference's scatter drops as out of range
        ncol = A.shape[1]
        dt = _ell_dtype(A, X)
        X = X.to(dt)
        acc = torch.zeros((ncol + 1, X.shape[1]), dtype=_acc_dtype(dt),
                          device=X.device)
        for b in A.buckets:
            K = b.cols.shape[1]
            _scatter_add(acc, b.cols.reshape(-1),
                         b.row_ids.repeat_interleave(K),
                         b.vals.to(dt).reshape(-1), X)
        return acc[:ncol].to(dt)
    rows, cols, vals = _coo_like(A)
    return _stream_scatter(cols, rows, vals, X, A.shape[1])


def spmm_dd(A, X):
    """fp64-class ``Y = A @ X`` from f32 arithmetic (binary or valued): a
    float64 tensor on X's device, rel ~1e-13 against an f64 product.

    ``A``: a unit-values EllMatrix / SegmentedEll, a `formats.ell.DdEll`
    (`build_ell_dd`), or a SparseOperator whose forward tiling is one
    (``col_perm`` applied to X, ``row_inv`` to Y). See
    `ops.ell_ops.ell_spmm_dd`; the reference returns numpy, this a
    tensor."""
    from ..linops import SparseOperator
    from .ell_ops import _f64_operand, ell_spmm_dd

    if isinstance(A, SparseOperator):
        def body(X):
            X = _f64_operand(X, A.fwd.device)
            if A.col_perm is not None:
                X = X[A.col_perm.long()]
            Y = ell_spmm_dd(A.fwd, X)
            if A.row_inv is not None:
                Y = Y[A.row_inv.long()]
            return Y

        # a product of the operator: replayed as one CUDA graph when
        # repeated; its torch ops are not counted (only the launches)
        with tracing.span("product", op="spmm_dd",
                          N=X.shape[1] if X.ndim > 1 else 1):
            return A.graphs.run(A, "spmm_dd", X, body)
    return ell_spmm_dd(A, X)
