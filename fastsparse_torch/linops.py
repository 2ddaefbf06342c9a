"""Sparse linear operators with dual tilings (counterpart of
``fastsparse/linops.py``).

`operator()` compiles a matrix and, with ``transpose=True``, its transpose
into layouts on one device, so every product, the transpose and the
normal equations included, is a forward pass through a kernel; without
the transpose tiling, the transpose products of COO, CSR and ELL tilings
run the scatter engine (`spmv_t`, `spmm_t`). Formats: ``"bsr"`` (the mono
layout, class panels or tile buckets, column-segmented past the BSR column
caps), ``"ell"`` and ``"ell-seg"`` (the f32 gather engine, or torch ops
for f64 values; column-segmented past ``SEG_COLS``), ``"hybrid"`` (dense
tiles and a dense-column block beside the gather engine), ``"coo"`` and
``"csr"`` (the scatter engines) and ``"auto"``, which picks among the
first four as the reference does; and the reference's ``reorder=``
orderings with their permutation boundary.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import numpy as np
import torch

from . import tracing
from .graphs import ProductGraphs
from .bench.model import (
    GATHER_PAD,
    GATHER_SLOT_S,
    _tile_counts,
    auto_threshold_from_counts,
    best_tile_m,
    dense_col_select,
)
from .config import (
    BSR_SEG_COLS_BINARY3,
    BSR_SEG_COLS_F32,
    DEFAULT,
    SEG_COLS,
    Config,
)
from .formats.bsr import build_bsr
from .formats.convert import to_coo, to_csr
from .formats.coo import BinaryCOO, binary_coo_from_scipy, coo_from_scipy
from .formats.ell import build_ell, build_ell_segmented
from .formats.hybrid import build_hybrid
from .formats.segmented import build_bsr_segmented
from .ops import spmm as _spmm_mod
from .ops import spmv as _spmv_mod
from .ops.assemble import attach_plan
from .ops.bsr_ops import mono_chain, pallas_supported
from .reorder.cluster import invert_perm

__all__ = ["SparseOperator", "operator"]


def _product(fn):
    """A product of `SparseOperator`: its ``product`` span around the
    operator's graph cache (`graphs.ProductGraphs.run`), which runs the
    eager body ``fn`` or replays it; ``reg``, where the product takes one,
    is part of the cache's key."""
    name = fn.__name__

    @functools.wraps(fn)
    def product(self, X, reg=None):
        with tracing.span("product", op=name,
                          N=X.shape[1] if X.ndim > 1 else 1):
            if reg is None:
                return self.graphs.run(self, name, X, lambda X: fn(self, X))
            return self.graphs.run(self, name, X, lambda X: fn(self, X, reg),
                                   reg)
    return product


@dataclasses.dataclass(frozen=True)
class SparseOperator:
    """A sparse matrix with a forward tiling ``fwd`` (``A·_``) and,
    optionally, a tiling ``bwd`` of ``Aᵀ`` (``Aᵀ·_`` as a forward
    product).

    Built with ``reorder=``, the tilings hold the permuted matrix
    ``P_r A P_cᵀ``, and operands are permuted at the boundary by row
    gathers: ``row_perm``/``col_perm`` (old index of the k-th permuted
    row/column) and their inverses, int32 tensors on the operator's device,
    or None.

    On the card, a product called again with the same operand shape is
    replayed as one CUDA graph (`graphs.ProductGraphs`, ``graphs``: shared
    with ``T``)."""

    fwd: Any
    bwd: Optional[Any]
    shape: tuple
    row_perm: Optional[torch.Tensor] = None
    col_perm: Optional[torch.Tensor] = None
    row_inv: Optional[torch.Tensor] = None
    col_inv: Optional[torch.Tensor] = None
    graphs: ProductGraphs = dataclasses.field(
        default_factory=ProductGraphs, init=False, repr=False, compare=False)

    @property
    def T(self) -> "SparseOperator":
        if self.bwd is None:
            raise ValueError("operator built without transpose=True")
        t = SparseOperator(
            fwd=self.bwd, bwd=self.fwd, shape=(self.shape[1], self.shape[0]),
            row_perm=self.col_perm, col_perm=self.row_perm,
            row_inv=self.col_inv, col_inv=self.row_inv,
        )
        object.__setattr__(t, "graphs", self.graphs)
        return t

    # -- permutation boundary ------------------------------------------------
    @staticmethod
    def _gather(x, perm):
        if perm is None:
            return x
        with tracing.span("boundary"):
            tracing.count()
            return x[perm]

    def _in_cols(self, x):
        return self._gather(x, self.col_perm)

    def _in_rows(self, x):
        return self._gather(x, self.row_perm)

    def _out_rows(self, y):
        return self._gather(y, self.row_inv)

    def _out_cols(self, y):
        return self._gather(y, self.col_inv)

    @_product
    def matvec(self, x):
        """``A @ x``."""
        return self._out_rows(_spmv_mod.spmv(self.fwd, self._in_cols(x)))

    @_product
    def rmatvec(self, x):
        """``Aᵀ @ x``: a forward product over the dual tiling when there is
        one, else the scatter engine over ``fwd`` (tiled formats raise
        `TypeError` there)."""
        if self.bwd is not None:
            y = _spmv_mod.spmv(self.bwd, self._in_rows(x))
        else:
            y = _spmv_mod.spmv_t(self.fwd, self._in_rows(x))
        return self._out_cols(y)

    @_product
    def matmat(self, X):
        """``A @ X``."""
        return self._out_rows(_spmm_mod.spmm(self.fwd, self._in_cols(X)))

    @_product
    def rmatmat(self, X):
        """``Aᵀ @ X``, as `rmatvec`."""
        if self.bwd is not None:
            Y = _spmm_mod.spmm(self.bwd, self._in_rows(X))
        else:
            Y = _spmm_mod.spmm_t(self.fwd, self._in_rows(X))
        return self._out_cols(Y)

    def _mono_chainable(self, X) -> bool:
        """Both tilings mono and an operand dtype with a kernel: normal and
        gram products then run as two back-to-back launches
        (`ops.bsr_ops.mono_chain`; the inner ``row_inv∘row_perm`` gather
        pair cancels exactly)."""
        return (
            self.bwd is not None
            and getattr(self.fwd, "is_mono", False)
            and getattr(self.bwd, "is_mono", False)
            and pallas_supported(X.dtype)
        )

    # the normal and gram products add ``reg·x``: two device ops
    @_product
    def normal_matvec(self, x, reg=0.0):
        """``(AᵀA + reg·I) @ x``, the Macau/SMURFF CG inner product."""
        tracing.count(2)
        if self._mono_chainable(x):
            y = mono_chain(self.fwd, self.bwd, self._in_cols(x)[:, None])
            return self._out_cols(y[:, 0]) + reg * x
        return self.rmatvec(self.matvec(x)) + reg * x

    @_product
    def normal_matmat(self, X, reg=0.0):
        """``(AᵀA + reg·I) @ X``."""
        tracing.count(2)
        if self._mono_chainable(X):
            Y = mono_chain(self.fwd, self.bwd, self._in_cols(X))
            return self._out_cols(Y) + reg * X
        return self.rmatmat(self.matmat(X)) + reg * X

    @_product
    def gram_matvec(self, x, reg=0.0):
        """``(AAᵀ + reg·I) @ x``."""
        tracing.count(2)
        if self._mono_chainable(x):
            y = mono_chain(self.bwd, self.fwd, self._in_rows(x)[:, None])
            return self._out_rows(y[:, 0]) + reg * x
        return self.matvec(self.rmatvec(x)) + reg * x

    def __matmul__(self, other):
        return self.matvec(other) if other.ndim == 1 else self.matmat(other)


_FORMATS = ("auto", "bsr", "ell", "ell-seg", "hybrid", "coo", "csr")

# Tiles emptier than this run faster on the gather engine than on the tile
# path (the reference's layout model)
BSR_OCCUPANCY_THRESHOLD = 0.02


def _balanced_seg_cols(ncol: int, cap: int = SEG_COLS) -> int:
    """Equal-width, 128-aligned column segments of at most ``cap`` columns
    (a short tail segment would pay full bucket padding for every row it
    holds)."""
    nseg = -(-ncol // cap)
    w = -(-(-(-ncol // nseg)) // 128) * 128
    while w > cap:  # 128-rounding may tip over the cap
        nseg += 1
        w = -(-(-(-ncol // nseg)) // 128) * 128
    return w


def tile_occupancy_estimate(coo, config: Config = DEFAULT) -> float:
    """nnz / (occupied tiles × tile area), computed host-side."""
    config = config.resolve()
    rows = coo.rows[: coo.n_valid].cpu().numpy()
    cols = coo.cols[: coo.n_valid].cpu().numpy()
    if rows.size == 0:
        return 0.0
    n_slabs = max(-(-coo.shape[1] // config.tile_k), 1)
    pair = (rows // config.tile_m) * n_slabs + cols // config.tile_k
    ntiles = np.unique(pair).size
    return rows.size / (ntiles * config.tile_m * config.tile_k)


def _value_dtype(coo, dtype):
    if dtype is not None:
        return dtype
    return torch.float32 if isinstance(coo, BinaryCOO) else coo.vals.dtype


def _auto_format(coo, config: Config, dtype) -> str:
    """The reference's ``format="auto"`` decision: the tile path when tiles
    are full enough, else hybrid or the gather engine by the cost model;
    values other than f32/bf16 go to ELL."""
    if _value_dtype(coo, dtype) not in (torch.float32, torch.bfloat16):
        return "ell"
    if tile_occupancy_estimate(coo, config) >= BSR_OCCUPANCY_THRESHOLD:
        return "bsr"
    rows = coo.rows[: coo.n_valid].cpu().numpy()
    cols = coo.cols[: coo.n_valid].cpu().numpy()
    cnt = _tile_counts(rows, cols, coo.shape, config.resolve().tile_m,
                       config.tile_k)
    th, hybrid_cost = auto_threshold_from_counts(cnt)
    all_sparse = GATHER_SLOT_S * GATHER_PAD * int(cnt.sum())
    hybrid = (cnt.size > 0 and th <= int(cnt.max())
              and hybrid_cost < 0.9 * all_sparse)
    if not hybrid and isinstance(coo, BinaryCOO):
        # high-degree columns alone can justify the dense-column block
        coldeg = np.bincount(cols, minlength=coo.shape[1])
        hybrid = dense_col_select(coldeg, coo.shape[0]).size > 0
    return "hybrid" if hybrid else "ell"


def _compile_bsr(coo, config: Config, dtype, device):
    """The reference's ``_compile_one(..., "bsr")``: a matrix wider than
    the column cap tries mono first (mono windows X, so it needs no column
    segments), else compiles one BSR layout per balanced column segment.
    A 0/1 matrix past ``BSR_SEG_COLS_BINARY3`` whose pieces are not all
    panel layouts is rebuilt at that tighter cap (the tile kernels' X
    planes take 6 bytes per element in the reference)."""
    def build(cap):
        if coo.shape[1] > cap:
            m = build_bsr(coo, config=config, dtype=dtype, mono_only=True,
                          device=device)
            if m is not None:
                return m
            return build_bsr_segmented(
                coo, config=config,
                seg_cols=_balanced_seg_cols(coo.shape[1], cap), dtype=dtype,
                device=device,
            )
        return build_bsr(coo, config=config, dtype=dtype, device=device)

    built = build(BSR_SEG_COLS_F32)
    binary3 = isinstance(coo, BinaryCOO) and dtype in (None, torch.float32)
    if binary3 and coo.shape[1] > BSR_SEG_COLS_BINARY3:
        pieces = getattr(built, "segments", (built,))
        if not all(getattr(p, "is_panel", False) for p in pieces):
            built = build(BSR_SEG_COLS_BINARY3)
    return built


def _compile_ell(coo, config: Config, dtype, device, segmented=False):
    """The reference's ``_compile_one(..., "ell" | "ell-seg")``: rows split
    at ``config.ell_split_rows`` (f32 only: other dtypes, and the fp64-class
    products, need the unsplit layout), column segments past ``SEG_COLS``
    (always, for ``segmented``)."""
    split = (config.resolve().ell_split_rows
             if _value_dtype(coo, dtype) == torch.float32 else 0)
    if segmented or coo.shape[1] > SEG_COLS:
        return build_ell_segmented(
            coo, config=config, seg_cols=_balanced_seg_cols(coo.shape[1]),
            dtype=dtype, split_rows=split, device=device,
        )
    return build_ell(coo, config=config, dtype=dtype, split_rows=split,
                     device=device)


def _compile_gather(coo, fmt, config: Config, dtype, device):
    """One tiling of the gather-engine family ("ell", "ell-seg",
    "hybrid")."""
    if fmt == "hybrid":
        return build_hybrid(coo, config=config, seg_cols=SEG_COLS,
                            dtype=dtype, device=device)
    return _compile_ell(coo, config, dtype, device,
                        segmented=fmt == "ell-seg")


def _reorder(coo, reorder):
    """(permuted coo, row_perm, col_perm) for ``reorder=``, perms None for
    no reordering."""
    if reorder in (None, "none"):
        return coo, None, None
    if reorder not in ("degree", "minhash", "tilepack", "hilbert", "auto"):
        raise ValueError(f"unknown reorder {reorder!r}")
    from .reorder import cluster

    row_perm, col_perm = {
        "degree": cluster.degree_perms,
        "minhash": cluster.minhash_perms,
        "tilepack": cluster.tilepack_perms,
        "hilbert": cluster.hilbert_perms,
        "auto": cluster.best_perms,
    }[reorder](coo)
    if row_perm is None:
        return coo, None, None
    return cluster.permute_coo(coo, row_perm, col_perm), row_perm, col_perm


def _hybrid_tile_share(coo, config: Config) -> float:
    """Share of the nonzeros the hybrid's tile part would carry, on what
    the dense-column extraction leaves."""
    rcfg = config.resolve()
    n = coo.n_valid
    r_np = coo.rows[:n].cpu().numpy()
    c_np = coo.cols[:n].cpu().numpy()
    if isinstance(coo, BinaryCOO):
        coldeg = np.bincount(c_np, minlength=coo.shape[1])
        sel = dense_col_select(coldeg, coo.shape[0])
        if sel.size:
            keep = ~np.isin(c_np, sel)
            r_np, c_np = r_np[keep], c_np[keep]
    cnt = _tile_counts(r_np, c_np, coo.shape, rcfg.tile_m, rcfg.tile_k)
    if not cnt.size:
        return 0.0
    th, _ = auto_threshold_from_counts(cnt)
    return float(cnt[cnt >= th].sum() / max(cnt.sum(), 1))


def _elide_perms(coo, fmt, config, row_perm, col_perm):
    """The reference's permutation-boundary elision for a gather-engine
    tiling without the dual one: bucket membership, the dense-column block
    and the hybrid split do not depend on row ids, so when the tile part
    would carry under 25 % of the nonzeros the rows go back to their
    original order (no output gather), and the column perm is kept only if
    its column-segment locality pays for the input gather (the reference's
    measured constants), with each segment's slice sorted. Returns (coo,
    row_perm, col_perm)."""
    tile_share = _hybrid_tile_share(coo, config) if fmt == "hybrid" else 0.0
    if tile_share >= 0.25:
        return coo, row_perm, col_perm
    if row_perm is not None:
        coo = dataclasses.replace(coo, rows=row_perm[coo.rows.long()],
                                  row_sorted=False)
        row_perm = None
    if col_perm is not None:
        ncol = coo.shape[1]
        w = _balanced_seg_cols(ncol)
        cp_old = col_perm.cpu().numpy()
        n = coo.n_valid
        c_cur = coo.cols[:n].cpu().numpy()
        r_cur = coo.rows[:n].cpu().numpy().astype(np.int64)
        orig = cp_old[c_cur]
        nseg = max(-(-ncol // w), 1)
        pairs_perm = np.unique(r_cur * nseg + c_cur // w).size
        pairs_orig = np.unique(r_cur * nseg + orig // w).size
        saved_s = (pairs_orig - pairs_perm) * 30e-9
        inperm_s = ncol * 10e-9
        if ncol <= w or saved_s < inperm_s:
            # segments keep the original contiguous column ranges
            coo = dataclasses.replace(coo, cols=col_perm[coo.cols.long()])
            col_perm = None
        else:
            # keep it, each segment's slice ascending (membership unchanged)
            cp_new = cp_old.copy()
            for off in range(0, ncol, w):
                cp_new[off : off + w].sort()
            inv_new = np.empty_like(cp_new)
            inv_new[cp_new] = np.arange(ncol, dtype=cp_new.dtype)
            remap = torch.as_tensor(inv_new[cp_old], device=coo.cols.device)
            coo = dataclasses.replace(coo, cols=remap[coo.cols.long()])
            col_perm = torch.as_tensor(cp_new, device=coo.cols.device)
    return coo, row_perm, col_perm


def operator(
    mat,
    format: str = "auto",
    transpose: bool = True,
    config: Config = DEFAULT,
    dtype=None,
    reorder: Optional[str] = None,
    tune: bool = False,
    device="cuda",
) -> SparseOperator:
    """Compile ``mat`` (a port COO/CSR or a scipy matrix) into a
    :class:`SparseOperator` on ``device`` (the card unless the caller asks
    for another).

    ``format="auto"`` takes the reference's decision: ``"bsr"`` when tiles
    are full, ``"hybrid"`` (dense tiles and dense columns beside the gather
    engine) or ``"ell"`` (the gather engine) for sparser structure, by the
    reference's cost model; values other than f32/bf16 (f64) go to
    ``"ell"``, built unsplit, whose products run the reference's per-bucket
    gather as torch ops. `spmm_dd` takes an ``"ell"`` operator of a 0/1
    matrix built with ``Config(ell_split_rows=0)``. ``"ell-seg"`` forces
    column segments.
    ``"coo"`` keeps the (padded) COO and ``"csr"`` converts it on the
    device (`to_csr`); their products run the scatter engines (`spmv`,
    `spmm`; the transpose tiling is the swapped COO). ``reorder``
    (``"degree"``, ``"minhash"``, ``"tilepack"``, ``"hilbert"`` or
    ``"auto"``) permutes rows and columns before tiling; products permute
    operands at the boundary, which the gather-engine formats elide without
    the dual tiling where the reference does. ``tune=True`` and bitmask
    tiles are slice 3b: they raise `NotImplementedError`. ``dtype``: a
    torch dtype or None. The COO's capacity is padded to a power of two,
    as the reference pads it (the layouts are built from its ``n_valid``
    live entries only). With ``config.tile_m=None`` the BSR tile height is the modeled
    best (`bench.model.best_tile_m`), raised from 128 to 256 when the
    taller build is still mono.
    """
    with tracing.span("build"):
        return _build(mat, format, transpose, config, dtype, reorder, tune,
                      device)


def _build(mat, format, transpose, config, dtype, reorder, tune, device):
    if format not in _FORMATS:
        raise ValueError(f"format must be one of {_FORMATS}")
    if tune:
        raise NotImplementedError(
            "tune=True (per-matrix bucket edges) is slice 3b"
        )
    if dtype is not None and not isinstance(dtype, torch.dtype):
        raise TypeError("dtype must be a torch dtype or None")
    if hasattr(mat, "tocoo"):  # scipy input
        m = mat.tocoo()
        if (m.data == 1.0).all() and dtype is None:
            coo = binary_coo_from_scipy(m, device=device)
        else:
            coo = coo_from_scipy(m, device=device)
    else:
        coo = to_coo(mat)
    cap = coo.nnz_cap
    pow2 = 1 if cap <= 1 else 1 << (cap - 1).bit_length()
    if cap != pow2:
        coo = coo.pad_to(pow2)

    # reorder before the format decision: the model must see the layout
    # the tilings are built from
    with tracing.span("build.reorder"):
        coo, row_perm, col_perm = _reorder(coo, reorder)
    if format == "auto":
        with tracing.span("build.format"):
            format = _auto_format(coo, config, dtype)
    if (format in ("ell", "ell-seg", "hybrid") and not transpose
            and (row_perm is not None or col_perm is not None)):
        with tracing.span("build.reorder"):
            coo, row_perm, col_perm = _elide_perms(coo, format, config,
                                                   row_perm, col_perm)
    if format == "bsr":
        fwd, bwd = _compile_bsr_pair(coo, config, dtype, device, transpose)
    elif format in ("coo", "csr"):
        if dtype is not None and not isinstance(coo, BinaryCOO):
            coo = dataclasses.replace(coo, vals=coo.vals.to(dtype))
        with tracing.span("build.fwd"):
            fwd = _compile_scatter(coo, format)
        with tracing.span("build.bwd"):
            bwd = (_compile_scatter(_transpose(coo), format) if transpose
                   else None)
    else:
        if config.tile_m is None:
            config = config.resolve()
        with tracing.span("build.fwd"):
            fwd = _compile_gather(coo, format, config, dtype, device)
        with tracing.span("build.bwd"):
            bwd = _compile_gather(_transpose(coo), format, config, dtype,
                                  device) if transpose else None
    with tracing.span("build.plan"):
        fwd, bwd = attach_plan(fwd), attach_plan(bwd)
    return SparseOperator(
        fwd=fwd, bwd=bwd, shape=tuple(coo.shape),
        row_perm=row_perm, col_perm=col_perm,
        row_inv=None if row_perm is None else invert_perm(row_perm),
        col_inv=None if col_perm is None else invert_perm(col_perm),
    )


def _compile_scatter(coo, fmt):
    """The reference's ``_compile_one(..., "coo" | "csr")``: the COO as it
    is, or its CSR."""
    return to_csr(coo) if fmt == "csr" else coo


def _transpose(coo):
    return dataclasses.replace(
        coo, rows=coo.cols, cols=coo.rows,
        shape=(coo.shape[1], coo.shape[0]), row_sorted=False,
    )


def _compile_bsr_pair(coo, config, dtype, device, transpose):
    with tracing.span("build.fwd"):
        fwd, config = _compile_bsr_fwd(coo, config, dtype, device)
    with tracing.span("build.bwd"):
        bwd = _compile_bsr(_transpose(coo), config, dtype, device) \
            if transpose else None
    return fwd, bwd


def _compile_bsr_fwd(coo, config, dtype, device):
    """The forward BSR tiling and the config it was built at (the tile
    height picked here when ``config.tile_m`` is None)."""
    auto_tm = config.tile_m is None
    if auto_tm:
        tm = best_tile_m(
            coo.rows[: coo.n_valid].cpu().numpy(),
            coo.cols[: coo.n_valid].cpu().numpy(),
            coo.shape,
            config.tile_k,
        )
        config = dataclasses.replace(config, tile_m=tm)
    fwd = _compile_bsr(coo, config, dtype, device)
    # taller mono items: keep tile_m=256 when that build is still mono
    if auto_tm and config.tile_m == 128 and getattr(fwd, "is_mono", False):
        cfg256 = dataclasses.replace(config, tile_m=256)
        fwd256 = _compile_bsr(coo, cfg256, dtype, device)
        if getattr(fwd256, "is_mono", False):
            fwd, config = fwd256, cfg256
    return fwd, config
