"""Gather-plan Y assembly for the ELL engine (counterpart of the ELL part of
``fastsparse/ops/assemble.py``).

`ell_spmm` collects per-part row panels and must sum them into Y. The slot
layout (which output row every part slot feeds) is fixed when the format
is built, so the sum runs as static row gathers instead of a scatter:

* output rows are grouped by multiplicity (how many real part slots feed
  them: one per column segment or split sub-row);
* per class ``c``: ``Yc = Σ_{s<c} parts_cat[pos_c[:, s]]``, in slot order;
* one final row gather ``Y = cat(Yc..., zero_row)[rowpos]`` puts the
  classes back in matrix order (empty rows read the zero row).

Row gathers are plain torch indexing, as the reference leaves them to XLA;
the summation order (class by class, slots in order) is the reference's.
Mono BSR layouts write Y in place and need no plan; a hybrid gets plans
on its parts; the tile-BSR strip plans are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

__all__ = [
    "AssemblyPlan",
    "attach_plan",
    "build_assembly_plan",
    "apply_plan",
    "layout_key",
]


def attach_plan(fmt):
    """``fmt`` with an :class:`AssemblyPlan` attached where the engine uses
    one (an f32 EllMatrix / SegmentedEll without a plan); a mono BsrMatrix
    passes through; a HybridMatrix recurses into its parts. Layouts whose
    plans are not ported raise."""
    from ..formats.bsr import BsrMatrix
    from ..formats.ell import EllMatrix, SegmentedEll

    if fmt is None:
        return None
    if type(fmt).__name__ == "HybridMatrix":
        return dataclasses.replace(fmt, dense=attach_plan(fmt.dense),
                                   sparse=attach_plan(fmt.sparse))
    if type(fmt).__name__ == "ColSegmented":
        raise NotImplementedError(
            "assembly plans for ColSegmented are slice 3"
        )
    if isinstance(fmt, BsrMatrix):
        if fmt.is_mono or not fmt.buckets:
            return fmt  # mono kernels write Y in place: no plan needed
        raise NotImplementedError("tile-BSR strip plans are slice 3")
    if isinstance(fmt, (EllMatrix, SegmentedEll)) and fmt.plan is None:
        segs = fmt.segments if isinstance(fmt, SegmentedEll) else (fmt,)
        if all(s.dtype == torch.float32 for s in segs):
            return dataclasses.replace(fmt, plan=build_assembly_plan(fmt))
    return fmt


@dataclasses.dataclass(frozen=True)
class AssemblyPlan:
    """Static gather schedule from part slots to output rows.

    ``classes[k]`` int32 ``(n_k, widths[k])``: positions in the
    concatenated parts of the rows with multiplicity ``widths[k]``, in the
    class's row order. ``rowpos`` int32 ``(nrow,)``: each output row's
    position in the class-concatenated panel (``n_total``, the appended
    zero row, for empty rows). ``layout_key``: the chunking state the plan
    was built under; on a mismatch `ell_spmm` falls back to a scatter."""

    classes: Tuple[torch.Tensor, ...]
    rowpos: torch.Tensor
    widths: Tuple[int, ...]
    n_slots: int  # rows of parts_cat the plan was built for
    layout_key: Tuple


def _slot_stream(A):
    """Host view of the part-slot layout: yields per appended part a
    ``(row_ids, valid)`` numpy pair, in exactly the order `ell_spmm`
    appends compute parts (both walk `ell_ops._seg_layout`)."""
    from . import ell_ops as eo
    from ..formats.ell import SegmentedEll

    segs = A.segments if isinstance(A, SegmentedEll) else [A]
    for seg in segs:
        cur_b, rid_full, valid_full = None, None, None
        for b, mode, s0, s1, n_pad in eo._seg_layout(seg):
            # a sweep's rows are its sub-parts concatenated in order
            subs = b if mode == "sweep" else ((b, s0, s1, n_pad),)
            for bb, t0, t1, np_ in subs:
                if bb is not cur_b:
                    cur_b = bb
                    rid_full = bb.row_ids.cpu().numpy()
                    valid_full = _valid_mask(bb)
                n = t1 - t0
                if t0 == 0 and t1 == len(rid_full) and np_ == t1:
                    yield rid_full, valid_full
                    continue
                rid = np.zeros(np_, rid_full.dtype)
                rid[:n] = rid_full[t0:t1]
                valid = np.zeros(np_, bool)
                valid[:n] = valid_full[t0:t1]
                yield rid, valid


def _valid_mask(b):
    """Per-slot liveness: the builder's real rows come first (``n_real``),
    so no index or value array is read."""
    return np.arange(b.cols.shape[0]) < b.n_real


def layout_key():
    """The chunking state plans are valid under (tests monkeypatch it)."""
    from . import ell_ops as eo

    return (
        eo._SMEM_IDX_BUDGET_UNIT,
        eo._SMEM_IDX_BUDGET_VALUED,
        eo.SMEM_BLOCK_K_UNIT,
        eo.SMEM_BLOCK_K_VALUED,
        eo.USE_SMEM_PATH,
        eo.USE_SWEEP,
        "sweep1",
    )


def _classes_from_slots(rid_all, valid_all, nrow):
    """Group part-slot positions by output row and multiplicity: returns
    ``(classes, widths, rowpos)`` as numpy arrays."""
    pos_all = np.nonzero(valid_all)[0]
    rows = rid_all[pos_all]
    order = np.argsort(rows, kind="stable")
    rows_s, pos_s = rows[order], pos_all[order]
    counts = np.bincount(rows_s.astype(np.int64), minlength=nrow)
    uniq_rows = np.unique(rows_s)
    starts = np.concatenate([[0], np.cumsum(counts[uniq_rows])[:-1]])

    classes, widths, rowpos = [], [], np.full((nrow,), -1, np.int64)
    out_off = 0
    for c in np.unique(counts[uniq_rows]):
        sel = counts[uniq_rows] == c
        rws = uniq_rows[sel]
        st = starts[sel]
        classes.append(pos_s[st[:, None] + np.arange(c)[None, :]])
        widths.append(int(c))
        rowpos[rws] = out_off + np.arange(len(rws))
        out_off += len(rws)
    rowpos[rowpos < 0] = out_off  # zero-row sentinel
    return classes, widths, rowpos


def build_assembly_plan(A) -> AssemblyPlan:
    """Host-side plan build (one pass over the buckets' row ids); the
    plan's tensors land on the format's device."""
    rids, valids = [], []
    for rid, valid in _slot_stream(A):
        rids.append(rid.astype(np.int64))
        valids.append(valid)
    rid_all = np.concatenate(rids) if rids else np.zeros((0,), np.int64)
    valid_all = np.concatenate(valids) if valids else np.zeros((0,), bool)
    classes, widths, rowpos = _classes_from_slots(rid_all, valid_all,
                                                  A.shape[0])
    dev = A.device or "cpu"

    def i32(a):
        return torch.as_tensor(a.astype(np.int32), device=dev)

    return AssemblyPlan(
        classes=tuple(i32(c) for c in classes),
        rowpos=i32(rowpos),
        widths=tuple(widths),
        n_slots=len(rid_all),
        layout_key=layout_key(),
    )


def apply_plan(plan: AssemblyPlan, parts_cat):
    """parts_cat f32 ``(n_slots, L)`` -> Y f32 ``(nrow, L)`` through the
    plan's gathers (no scatter)."""
    ys = []
    for c, pos_c in zip(plan.widths, plan.classes):
        pos = pos_c.long()
        yc = parts_cat[pos[:, 0]]
        for s in range(1, c):
            yc = yc + parts_cat[pos[:, s]]
        ys.append(yc)
    ys.append(parts_cat.new_zeros((1, parts_cat.shape[1])))
    return torch.cat(ys)[plan.rowpos.long()]
