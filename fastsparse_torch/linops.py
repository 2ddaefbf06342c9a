"""Sparse linear operators with dual tilings (counterpart of
``fastsparse/linops.py``).

`operator()` compiles a matrix and, with ``transpose=True``, its transpose
into layouts on one device, so every product, the transpose and the
normal equations included, is a forward pass through a kernel. Ported
formats: ``"bsr"`` compiled to the mono layout, ``"ell"`` (the f32 gather
engine, column-segmented past ``SEG_COLS``) and ``"auto"``, which picks
between them as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

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
from .formats.convert import to_coo
from .formats.coo import BinaryCOO, binary_coo_from_scipy, coo_from_scipy
from .formats.ell import EllMatrix, SegmentedEll, build_ell, build_ell_segmented
from .ops import spmm as _spmm_mod
from .ops import spmv as _spmv_mod
from .ops.assemble import attach_plan
from .ops.bsr_ops import mono_chain

__all__ = ["SparseOperator", "operator"]


@dataclasses.dataclass(frozen=True)
class SparseOperator:
    """A sparse matrix with a forward tiling ``fwd`` (``A·_``) and,
    optionally, a tiling ``bwd`` of ``Aᵀ`` (``Aᵀ·_`` as a forward
    product)."""

    fwd: Any
    bwd: Optional[Any]
    shape: tuple

    @property
    def T(self) -> "SparseOperator":
        if self.bwd is None:
            raise ValueError("operator built without transpose=True")
        return SparseOperator(fwd=self.bwd, bwd=self.fwd,
                              shape=(self.shape[1], self.shape[0]))

    def _bwd(self):
        if self.bwd is None and isinstance(self.fwd, (EllMatrix, SegmentedEll)):
            raise NotImplementedError(
                "ELL transpose products without the dual tiling (the "
                "reference's scatter engine) are slice 4; build with "
                "operator(..., transpose=True)"
            )
        if self.bwd is None:
            raise TypeError(
                "tiled formats have no transpose-scatter path; build the "
                "dual tiling with operator(..., transpose=True)"
            )
        return self.bwd

    def matvec(self, x):
        """``A @ x``."""
        return _spmv_mod.spmv(self.fwd, x)

    def rmatvec(self, x):
        """``Aᵀ @ x`` through the dual tiling."""
        return _spmv_mod.spmv(self._bwd(), x)

    def matmat(self, X):
        """``A @ X``."""
        return _spmm_mod.spmm(self.fwd, X)

    def rmatmat(self, X):
        """``Aᵀ @ X`` through the dual tiling."""
        return _spmm_mod.spmm(self._bwd(), X)

    def _mono_chainable(self) -> bool:
        """Both tilings mono: normal and gram products then run as two
        back-to-back launches (`ops.bsr_ops.mono_chain`)."""
        return (
            self.bwd is not None
            and getattr(self.fwd, "is_mono", False)
            and getattr(self.bwd, "is_mono", False)
        )

    def normal_matvec(self, x, reg=0.0):
        """``(AᵀA + reg·I) @ x``, the Macau/SMURFF CG inner product."""
        if self._mono_chainable():
            return mono_chain(self.fwd, self.bwd, x[:, None])[:, 0] + reg * x
        return self.rmatvec(self.matvec(x)) + reg * x

    def normal_matmat(self, X, reg=0.0):
        """``(AᵀA + reg·I) @ X``."""
        if self._mono_chainable():
            return mono_chain(self.fwd, self.bwd, X) + reg * X
        return self.rmatmat(self.matmat(X)) + reg * X

    def gram_matvec(self, x, reg=0.0):
        """``(AAᵀ + reg·I) @ x``."""
        if self._mono_chainable():
            return mono_chain(self.bwd, self.fwd, x[:, None])[:, 0] + reg * x
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
    """The reference's ``_compile_one(..., "bsr")``: wide matrices try mono
    first (mono windows X, so it needs no column segments); what is left
    would be a column-segmented layout, which is slice 3."""
    def build(cap):
        if coo.shape[1] > cap:
            m = build_bsr(coo, config=config, dtype=dtype, mono_only=True,
                          device=device)
            if m is None:
                raise NotImplementedError(
                    "column-segmented BSR layouts are slice 3"
                )
            return m
        return build_bsr(coo, config=config, dtype=dtype, device=device)

    built = build(BSR_SEG_COLS_F32)
    binary3 = isinstance(coo, BinaryCOO) and dtype in (None, torch.float32)
    if binary3 and coo.shape[1] > BSR_SEG_COLS_BINARY3 and not built.is_mono:
        built = build(BSR_SEG_COLS_BINARY3)
    return built


def _compile_ell(coo, config: Config, dtype, device):
    """The reference's ``_compile_one(..., "ell")``: rows split at
    ``config.ell_split_rows`` (f32 only), column segments past
    ``SEG_COLS``."""
    if _value_dtype(coo, dtype) != torch.float32:
        raise NotImplementedError(
            "ELL with values other than f32 runs off the gather engine in "
            "the reference (fp64-class and XLA engines): slice 4 (fp64)"
        )
    split = config.resolve().ell_split_rows
    if coo.shape[1] > SEG_COLS:
        return build_ell_segmented(
            coo, config=config, seg_cols=_balanced_seg_cols(coo.shape[1]),
            dtype=dtype, split_rows=split, device=device,
        )
    return build_ell(coo, config=config, dtype=dtype, split_rows=split,
                     device=device)


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

    ``format="auto"`` takes the reference's decision: ``"bsr"`` (the mono
    layout) when tiles are full, ``"ell"`` (the gather engine) for
    hypersparse structure. ``"hybrid"``, ``"ell-seg"``, ``"coo"``,
    ``"csr"``, ``reorder`` and ``tune=True`` are slice 2b, and ELL with
    values other than f32 slice 4: they raise `NotImplementedError`, as
    does a structure the reference compiles to a layout not ported yet.
    ``dtype``: a torch dtype or None. With ``config.tile_m=None`` the BSR
    tile height is the modeled best (`bench.model.best_tile_m`), raised
    from 128 to 256 when the taller build is still mono.
    """
    if format not in _FORMATS:
        raise ValueError(f"format must be one of {_FORMATS}")
    if format in ("ell-seg", "hybrid", "coo", "csr"):
        raise NotImplementedError(f"format={format!r} is slice 2b")
    if reorder not in (None, "none") or tune:
        raise NotImplementedError("reorder= and tune=True are slice 2b")
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

    if format == "auto":
        format = _auto_format(coo, config, dtype)
        if format == "hybrid":
            raise NotImplementedError(
                "format='auto' picks 'hybrid' for this matrix (dense tiles "
                "or dense columns beside the gather engine): slice 2b"
            )
    if format == "ell":
        fwd = _compile_ell(coo, config, dtype, device)
        bwd = _compile_ell(_transpose(coo), config, dtype, device) \
            if transpose else None
    else:
        fwd, bwd = _compile_bsr_pair(coo, config, dtype, device, transpose)
    return SparseOperator(fwd=attach_plan(fwd), bwd=attach_plan(bwd),
                          shape=tuple(coo.shape))


def _transpose(coo):
    return dataclasses.replace(
        coo, rows=coo.cols, cols=coo.rows,
        shape=(coo.shape[1], coo.shape[0]), row_sorted=False,
    )


def _compile_bsr_pair(coo, config, dtype, device, transpose):
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
    if auto_tm and config.tile_m == 128 and fwd.is_mono:
        cfg256 = dataclasses.replace(config, tile_m=256)
        try:
            fwd256 = _compile_bsr(coo, cfg256, dtype, device)
        except NotImplementedError:  # the 256 build is not mono
            fwd256 = None
        if fwd256 is not None and fwd256.is_mono:
            fwd, config = fwd256, cfg256
    bwd = _compile_bsr(_transpose(coo), config, dtype, device) \
        if transpose else None
    return fwd, bwd
