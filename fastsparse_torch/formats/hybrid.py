"""Hybrid execution format (counterpart of ``fastsparse/formats/hybrid.py``).

A matrix splits into up to three parts, summed by the products:

* ``dense_cols`` (`DenseCols`): the high-degree columns of a binary matrix
  as one dense int8 0/1 block, multiplied by the `densecols_spmm` kernel;
* ``sparse``: the scattered rest as bucketed ELL for the gather engine;
* ``dense``: (tile_m × tile_k) tiles holding at least ``threshold``
  entries, as a BSR layout (tile buckets or class panels, a `ColSegmented`
  of them past the BSR column cap), multiplied by the tile kernels.

The split is decided on the host with numpy and reproduces the
reference's: dense-column extraction first, then the occupancy threshold
(`bench.model.auto_threshold`) on what is left, then the tile split.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..bench import model as _model
from ..config import DEFAULT, SEG_COLS, Config
from .coo import COO, BinaryCOO
from .csr import CSR, BinaryCSR
from .ell import build_ell, build_ell_segmented

__all__ = [
    "DenseCols",
    "HybridMatrix",
    "build_hybrid",
    "dense_tile_fraction",
]


@dataclasses.dataclass(frozen=True)
class DenseCols:
    """High-degree columns stored as one dense int8 0/1 block.

    ``col_ids`` are the extracted original columns, ascending, zero-padded
    to ``D_pad`` (a multiple of 128); ``block`` has ``nrow`` rounded up to
    a multiple of 256 rows, zero past ``nrow`` and past ``n_cols``."""

    col_ids: torch.Tensor  # int32[D_pad]
    block: torch.Tensor  # int8[nrow_pad, D_pad], 0/1
    shape: tuple  # parent (nrow, ncol)
    nnz: int  # real entries in the block
    n_cols: int = -1  # real (unpadded) column count

    def todense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=torch.float32,
                          device=self.block.device)
        # index_add_: padding col_ids repeat column 0 with all-zero block
        # columns, which add nothing
        out.index_add_(1, self.col_ids.long(),
                       self.block[: self.shape[0]].to(torch.float32))
        return out


@dataclasses.dataclass(frozen=True)
class HybridMatrix:
    """``dense`` (BsrMatrix | ColSegmented) + ``sparse`` (bucketed ELL) +
    ``dense_cols`` (`DenseCols`) split of one matrix."""

    dense: Optional[Any]
    sparse: Optional[Any]  # EllMatrix | SegmentedEll | None
    shape: tuple
    nnz: int
    dense_nnz: int
    threshold: int
    dense_cols: Optional[DenseCols] = None

    @property
    def dense_fraction(self) -> float:
        return self.dense_nnz / max(self.nnz, 1)

    @property
    def dtype(self):
        if self.dense is not None:
            return self.dense.dtype
        if self.sparse is not None:
            return self.sparse.dtype
        return torch.float32

    @property
    def device(self):
        for part in (self.sparse, self.dense):
            if part is not None and part.device is not None:
                return part.device
        if self.dense_cols is not None:
            return self.dense_cols.block.device
        return None

    def todense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=torch.float32,
                          device=self.device or "cpu")
        for part in (self.dense, self.sparse, self.dense_cols):
            if part is not None:
                out = out + part.todense().to(torch.float32)
        return out


def _host(mat):
    """(rows int64, cols int64, vals tensor | None, binary) of the live
    entries, on the host."""
    if isinstance(mat, (CSR, BinaryCSR)):
        mat = mat.to_coo()
    binary = isinstance(mat, BinaryCOO)
    n = mat.n_valid
    rows = mat.rows[:n].cpu().numpy().astype(np.int64)
    cols = mat.cols[:n].cpu().numpy().astype(np.int64)
    vals = None if binary else mat.vals[:n].cpu()
    return rows, cols, vals, binary


def _dense_sel(rows, cols, ncol, tm, tk, threshold):
    """The tile split: entries of (tm × tk) tiles holding >= threshold
    entries."""
    n_slabs = max(-(-ncol // tk), 1)
    pair = (rows // tm) * n_slabs + cols // tk
    _, inv, cnt = np.unique(pair, return_inverse=True, return_counts=True)
    return cnt[inv] >= threshold


def dense_tile_fraction(mat, config: Config = DEFAULT,
                        threshold: int = 64) -> float:
    """Fraction of nonzeros in tiles holding >= threshold entries."""
    config = config.resolve()
    rows, cols, _, _ = _host(mat)
    sel = _dense_sel(rows, cols, mat.shape[1], config.tile_m, config.tile_k,
                     threshold)
    return float(sel.mean()) if sel.size else 0.0


def _extract_dense_cols(rows, cols, shape, device):
    """(keep_mask, DenseCols | None): move the high-degree columns' entries
    (`bench.model.dense_col_select`) into one dense int8 block."""
    nrow, ncol = shape
    coldeg = np.bincount(cols, minlength=ncol)
    sel_cols = _model.dense_col_select(coldeg, nrow)
    if sel_cols.size == 0:
        return None, None
    pos = np.full(ncol, -1, np.int64)
    pos[sel_cols] = np.arange(sel_cols.size)
    in_dense = pos[cols] >= 0
    # the reference's padding, kept for layout parity: D to a multiple of
    # 128 (zero block columns; their X rows read col_ids[0]) and rows to a
    # multiple of 256
    D_pad = -(-sel_cols.size // 128) * 128
    nrow_pad = -(-nrow // 256) * 256
    block = np.zeros((nrow_pad, D_pad), np.int8)
    block[rows[in_dense], pos[cols[in_dense]]] = 1
    cid = np.zeros(D_pad, np.int32)
    cid[: sel_cols.size] = sel_cols
    dc = DenseCols(
        col_ids=torch.as_tensor(cid, device=device),
        block=torch.as_tensor(block, device=device),
        shape=tuple(shape),
        nnz=int(in_dense.sum()),
        n_cols=int(sel_cols.size),
    )
    return ~in_dense, dc


def build_hybrid(mat, config: Config = DEFAULT, threshold="auto",
                 seg_cols: int = SEG_COLS, dtype=None,
                 device="cuda") -> HybridMatrix:
    """Split ``mat`` into dense columns + dense tiles + scattered tail, on
    ``device``.

    The high-degree columns of a binary matrix are extracted first.
    ``threshold="auto"`` picks the tile-occupancy cutoff minimizing the
    modeled product cost on what the dense-column extraction left
    (`bench.model.auto_threshold`); an int pins it. Entries of tiles at or
    over the threshold compile into BSR (column-segmented past
    ``BSR_SEG_COLS_BINARY3`` for 0/1 input, ``BSR_SEG_COLS_F32`` else),
    with the modeled-best tile height when ``config.tile_m`` is None; the
    rest into ELL.
    """
    auto_tm = config.tile_m is None
    config = config.resolve()
    shape = tuple(mat.shape)
    rows, cols, vals, binary = _host(mat)
    dc = None
    if binary:
        keep, dc = _extract_dense_cols(rows, cols, shape, device)
        if dc is not None:
            rows, cols = rows[keep], cols[keep]
    if threshold == "auto":
        threshold = _model.auto_threshold(rows, cols, shape, config.tile_m,
                                          config.tile_k)
    sel = _dense_sel(rows, cols, shape[1], config.tile_m, config.tile_k,
                     threshold)

    def make_coo(idx):
        if binary:
            return BinaryCOO.from_arrays(rows[idx], cols[idx], shape,
                                         device="cpu")
        return COO(rows=torch.as_tensor(rows[idx].astype(np.int32)),
                   cols=torch.as_tensor(cols[idx].astype(np.int32)),
                   vals=vals[torch.as_tensor(np.nonzero(idx)[0])],
                   shape=shape, n_valid=int(idx.sum()))

    from ..linops import (
        BSR_SEG_COLS_BINARY3,
        BSR_SEG_COLS_F32,
        _balanced_seg_cols,
    )

    dense = sparse = None
    n_dense = int(sel.sum())
    bsr_cap = (BSR_SEG_COLS_BINARY3 if binary and dtype in (None, torch.float32)
               else BSR_SEG_COLS_F32)
    if n_dense and auto_tm:
        # taller tiles for the dense core when it merges vertically
        tm = _model.best_tile_m(rows[sel], cols[sel], shape, config.tile_k)
        if tm != config.tile_m:
            config = dataclasses.replace(config, tile_m=tm)
    if n_dense:
        if shape[1] > bsr_cap:
            from .segmented import build_bsr_segmented

            dense = build_bsr_segmented(
                make_coo(sel), config=config,
                seg_cols=_balanced_seg_cols(shape[1], bsr_cap), dtype=dtype,
                device=device,
            )
        else:
            from .bsr import build_bsr

            dense = build_bsr(make_coo(sel), config=config, dtype=dtype,
                              device=device)
    if (~sel).any():
        rest = make_coo(~sel)
        # hybrid is gather-engine machinery: long rows split so every
        # bucket rides the whole-row packed body
        split = config.ell_split_rows
        if shape[1] > seg_cols:
            sparse = build_ell_segmented(
                rest, config=config,
                seg_cols=_balanced_seg_cols(shape[1], seg_cols), dtype=dtype,
                split_rows=split, device=device,
            )
        else:
            sparse = build_ell(rest, config=config, dtype=dtype,
                               split_rows=split, device=device)
    return HybridMatrix(
        dense=dense,
        sparse=sparse,
        shape=shape,
        nnz=int(rows.size) + (dc.nnz if dc is not None else 0),
        dense_nnz=n_dense,
        threshold=threshold,
        dense_cols=dc,
    )
