"""Column segmentation of BSR layouts (counterpart of
``fastsparse/formats/segmented.py``).

`ColSegmented` splits a matrix into column ranges and builds a BSR layout
per range; products sum the segments' contributions (`ops.spmm`, through
one cross-segment gather plan, `ops.assemble.build_colseg_plan`). The
reference segments so that each segment's X panel fits the TPU's VMEM;
the port keeps the segment widths (``BSR_SEG_COLS_*``) as layout
parameters, so both packages build the same layout.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from ..config import DEFAULT, Config
from .coo import COO, BinaryCOO

__all__ = ["ColSegmented", "segment_coo", "build_bsr_segmented"]


def _ceil_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (int(x) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class ColSegmented:
    """Column-range split: segment ``i`` covers columns
    ``[col_offsets[i], col_offsets[i] + segments[i].shape[1])``. ``plan``:
    the cross-segment strip assembly (`ops.assemble.AssemblyPlan` with
    ``row_srcs``), or None."""

    segments: Tuple[Any, ...]
    col_offsets: tuple
    seg_cols: int
    shape: tuple
    nnz: int
    plan: Any = None

    @property
    def dtype(self):
        return self.segments[0].dtype

    @property
    def device(self):
        for s in self.segments:
            if s.device is not None:
                return s.device
        return None

    def todense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=torch.float32,
                          device=self.device or "cpu")
        for off, seg in zip(self.col_offsets, self.segments):
            d = seg.todense().to(torch.float32)
            out[:, off : off + d.shape[1]] += d.to(out.device)
        return out


def segment_coo(mat, seg_cols: int):
    """Split a COO into ``(offset, sub-COO)`` column ranges of ``seg_cols``
    columns. Sub-COOs keep global rows and segment-local columns, on the
    input's device, all padded to one shared power-of-two entry capacity
    (as the reference pads them; padding entries are (0, 0) with value 0
    past ``n_valid``)."""
    binary = isinstance(mat, BinaryCOO)
    nrow, ncol = mat.shape
    n = mat.n_valid
    dev = mat.rows.device
    rows = mat.rows[:n].cpu().numpy()
    cols = mat.cols[:n].cpu().numpy()
    vals = None if binary else mat.vals[:n].cpu()
    nseg = max(-(-ncol // seg_cols), 1)
    sels = [(cols >= si * seg_cols) & (cols < (si + 1) * seg_cols)
            for si in range(nseg)]
    cap = _ceil_pow2(max(max(int(s.sum()) for s in sels), 1))
    out = []
    for si, sel in enumerate(sels):
        lo = si * seg_cols
        hi = min(lo + seg_cols, ncol)
        k = int(sel.sum())
        r = np.zeros(cap, np.int32)
        c = np.zeros(cap, np.int32)
        r[:k] = rows[sel]
        c[:k] = cols[sel] - lo
        r_t = torch.as_tensor(r, device=dev)
        c_t = torch.as_tensor(c, device=dev)
        if binary:
            sub = BinaryCOO(rows=r_t, cols=c_t, shape=(nrow, hi - lo),
                            n_valid=k)
        else:
            v = torch.zeros(cap, dtype=vals.dtype)
            v[:k] = vals[torch.as_tensor(np.nonzero(sel)[0])]
            sub = COO(rows=r_t, cols=c_t, vals=v.to(dev),
                      shape=(nrow, hi - lo), n_valid=k)
        out.append((lo, sub))
    return out


def build_bsr_segmented(mat, config: Config = DEFAULT, seg_cols: int = 16384,
                        dtype=None, device="cuda") -> ColSegmented:
    """Column-segmented BSR: one `build_bsr` layout per ``seg_cols``-wide
    column range, on ``device``."""
    from .bsr import build_bsr

    segments, offsets, nnz = [], [], 0
    for lo, sub in segment_coo(mat, seg_cols):
        segments.append(build_bsr(sub, config=config, dtype=dtype,
                                  device=device))
        offsets.append(lo)
        nnz += sub.n_valid
    return ColSegmented(segments=tuple(segments), col_offsets=tuple(offsets),
                        seg_cols=seg_cols, shape=tuple(mat.shape), nnz=nnz)
