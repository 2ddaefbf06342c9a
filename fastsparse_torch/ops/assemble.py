"""Gather-plan Y assembly (counterpart of ``fastsparse/ops/assemble.py``).

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
On the card one kernel (`kernels.assemble.plan_sum`) runs the same sums
instead: every plan carries a row-ordered schedule derived from its own
arrays at build (`plan_schedule`), and each output row is written once,
bit-equal to the torch ops, which stay the CPU path. `sum_plan` is the
one place that chooses between them.

The tile-bucket and class-panel BSR layouts get a `BsrStripPlan` (strips
are disjoint across buckets, so Y is one gather of the per-part strip
panels), a `ColSegmented` of them an `AssemblyPlan` whose ``row_srcs``
sum each output row's per-segment panels. Mono BSR layouts write Y in
place and need no plan; a hybrid gets plans on its parts.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from .. import tracing
from .kernels.assemble import plan_sum

__all__ = [
    "AssemblyPlan",
    "BsrStripPlan",
    "attach_plan",
    "build_assembly_plan",
    "build_colseg_plan",
    "build_strip_plan",
    "apply_plan",
    "sum_plan",
    "plain_sum",
    "plan_schedule",
    "make_plan",
    "bsr_layout_key",
    "colseg_layout_key",
    "layout_key",
]


def attach_plan(fmt):
    """``fmt`` with assembly plans attached where the engines use them: an
    f32 EllMatrix / SegmentedEll an :class:`AssemblyPlan`, a tile-bucket or
    class-panel BsrMatrix a :class:`BsrStripPlan`, a ColSegmented of
    BsrMatrix with no mono segment its cross-segment :class:`AssemblyPlan`
    (after its segments get theirs); a HybridMatrix recurses into its
    parts. A mono or empty BsrMatrix passes through."""
    from ..formats.bsr import BsrMatrix
    from ..formats.ell import EllMatrix, SegmentedEll

    if fmt is None:
        return None
    if type(fmt).__name__ == "HybridMatrix":
        return dataclasses.replace(fmt, dense=attach_plan(fmt.dense),
                                   sparse=attach_plan(fmt.sparse))
    if type(fmt).__name__ == "ColSegmented":
        fmt = dataclasses.replace(
            fmt, segments=tuple(attach_plan(s) for s in fmt.segments))
        # a mono segment writes Y in place and has no strip panels to
        # gather: without a plan the product sums the segments' own
        # products (the reference raises here instead)
        if (fmt.plan is None and fmt.segments
                and all(isinstance(s, BsrMatrix) and not s.is_mono
                        for s in fmt.segments)):
            fmt = dataclasses.replace(fmt, plan=build_colseg_plan(fmt))
        return fmt
    if isinstance(fmt, BsrMatrix):
        if fmt.is_mono or not fmt.buckets or fmt.strip_plan is not None:
            return fmt  # mono kernels write Y in place: no plan needed
        return dataclasses.replace(fmt, strip_plan=build_strip_plan(fmt))
    if isinstance(fmt, (EllMatrix, SegmentedEll)) and fmt.plan is None:
        segs = fmt.segments if isinstance(fmt, SegmentedEll) else (fmt,)
        if all(s.dtype == torch.float32 for s in segs):
            return dataclasses.replace(fmt, plan=build_assembly_plan(fmt))
    return fmt


@dataclasses.dataclass(frozen=True)
class BsrStripPlan:
    """Strip-gather schedule of a tile-bucket or class-panel BsrMatrix.

    ``pos`` int32 ``(n_strips,)``: the row of the concatenated per-part
    strip panels holding strip ``s``'s output (``n_parts``, the appended
    zero panel, for empty strips). ``row_pos`` int32 ``(nrow,)``: the same
    per output row in the flattened ``(n_parts·TM + 1, Npad)`` parts (one
    gather gives the exact ``(nrow, Npad)`` output), or None past int32."""

    pos: torch.Tensor
    n_parts: int
    layout_key: Tuple
    row_pos: Any = None


def bsr_layout_key():
    """The BSR chunking state strip plans are valid under."""
    from . import bsr_ops as bo

    return (bo._SMEM_IDX_BUDGET,)


def colseg_layout_key():
    return ("colseg",) + bsr_layout_key()


def _i32(a, device):
    return torch.as_tensor(np.asarray(a).astype(np.int32), device=device)


def build_strip_plan(A) -> BsrStripPlan:
    """Host-side strip plan: one ``strip_ids`` fetch per bucket, walking
    `bsr_ops._bsr_layout` (the same part order `bsr_spmm` appends)."""
    from . import bsr_ops as bo

    nsp = A.n_strips
    pos = np.full((nsp,), -1, np.int64)
    off = 0
    cur_b, sid_full = None, None
    for b, s0, s1, n_pad in bo._bsr_layout(A):
        if b is not cur_b:
            cur_b = b
            sid_full = b.strip_ids.cpu().numpy()
        sid = sid_full[s0:s1]
        real = sid < nsp  # padding slots point at the dump strip
        pos[sid[real]] = off + np.nonzero(real)[0]
        off += n_pad
    pos[pos < 0] = off  # zero-panel sentinel for empty strips
    rp = _row_positions(pos[None, :], off, A.tile_m, A.shape[0])
    dev = A.device
    return BsrStripPlan(
        pos=_i32(pos, dev), n_parts=int(off), layout_key=bsr_layout_key(),
        row_pos=None if rp is None else _i32(rp[0], dev),
    )


def _row_positions(slot_of_strip, n_parts, TM, nrow):
    """Strip-level slot positions ``(n_levels, n_strips)`` (sentinel
    ``n_parts``) -> per level, each output row's index in the flattened
    ``(n_parts·TM + 1, Npad)`` parts (last row zero), as int64 numpy; None
    when that index would overflow int32."""
    if (n_parts + 1) * TM >= 2**31:
        return None
    r = np.arange(nrow, dtype=np.int64)
    s, q = r // TM, r % TM
    return [np.where(lvl[s] < n_parts, lvl[s] * TM + q, n_parts * TM)
            for lvl in np.asarray(slot_of_strip, np.int64)]


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
    # the row-ordered schedule `kernels.assemble.plan_sum` walks
    # (`plan_schedule`): int32 ``row_ptr`` (rows + 1) and ``src``
    row_ptr: torch.Tensor
    src: torch.Tensor
    n_levels: int
    # cross-segment strip plans only: ``row_srcs[m][r]`` is output row r's
    # m-th contribution in the flattened ``(n_slots·TM + 1, Npad)`` parts
    # (sentinel: the zero row)
    row_srcs: Tuple[torch.Tensor, ...] = ()


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


def plan_schedule(classes, rowpos, row_srcs=(), zero_row=None):
    """The row-ordered schedule of a plan's host arrays: ``(row_ptr, src,
    n_levels)``, output row r summing rows ``src[row_ptr[r]:row_ptr[r+1]]``
    of the parts in order, as the torch ops sum them.

    A class plan: row r lists ``classes[k][i]``, where ``rowpos[r]`` puts
    it at position i of class k; an empty row lists nothing (it reads the
    zero row, +0.0). A ``row_srcs`` plan: row r lists ``row_srcs[0][r],
    row_srcs[1][r], ...`` up to its first ``zero_row`` sentinel, and
    ``n_levels`` is the number of levels: a row of 1..n_levels-1 sources
    is followed by sentinel levels, whose ``+ 0.0`` turns -0.0 into +0.0."""
    if len(row_srcs):
        lv = np.stack([np.asarray(r, np.int64) for r in row_srcs])
        real = lv != zero_row
        if np.any(real[1:] & ~real[:-1]):
            raise ValueError("plan_schedule: a row source after a sentinel")
        counts = real.sum(axis=0)
        src = lv.T[real.T]
        n_levels = len(row_srcs)
    else:
        rowpos = np.asarray(rowpos, np.int64)
        classes = [np.asarray(c) for c in classes]
        pos_width = np.repeat([c.shape[1] for c in classes],
                              [c.shape[0] for c in classes])
        live = np.nonzero(rowpos < len(pos_width))[0]
        counts = np.zeros(len(rowpos), np.int64)
        counts[live] = pos_width[rowpos[live]]
        row_of = np.empty(len(pos_width), np.int64)
        row_of[rowpos[live]] = live
        first = np.cumsum(counts) - counts
        src = np.empty(counts.sum(), np.int64)
        off = 0
        for c in classes:
            rows = row_of[off : off + c.shape[0]]
            src[first[rows][:, None] + np.arange(c.shape[1])] = c
            off += c.shape[0]
        n_levels = 0
    row_ptr = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return row_ptr, src, n_levels


def make_plan(classes, rowpos, widths, n_slots, layout_key, device,
              row_srcs=(), tile_m=None) -> AssemblyPlan:
    """An :class:`AssemblyPlan` on ``device`` from host arrays, with its
    schedule (`plan_schedule`); every constructor goes through here.
    ``row_srcs`` (a cross-segment plan's, strips of ``tile_m`` rows) index
    the flattened parts, whose row ``n_slots·tile_m`` is the zero row."""
    zero_row = n_slots * tile_m if len(row_srcs) else None
    row_ptr, src, n_levels = plan_schedule(classes, rowpos, row_srcs,
                                           zero_row)
    return AssemblyPlan(
        classes=tuple(_i32(c, device) for c in classes),
        rowpos=_i32(rowpos, device),
        widths=tuple(int(w) for w in widths),
        n_slots=int(n_slots),
        layout_key=tuple(layout_key),
        row_srcs=tuple(_i32(r, device) for r in row_srcs),
        row_ptr=_i32(row_ptr, device),
        src=_i32(src, device),
        n_levels=n_levels,
    )


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
    return make_plan(classes, rowpos, widths, len(rid_all), layout_key(),
                     A.device or "cpu")


def build_colseg_plan(A) -> AssemblyPlan:
    """Cross-segment strip plan for a ColSegmented of BsrMatrix: a strip
    appears once per segment its entries touch, each time as one
    ``(TM, Npad)`` part panel. Multiplicity classes over the strips, and
    the row-granular ``row_srcs`` `bsr_ops.colseg_spmm` sums."""
    from . import bsr_ops as bo

    nsp = A.segments[0].n_strips
    sids, valids = [], []
    for seg in A.segments:
        cur_b, sid_full = None, None
        for b, s0, s1, n_pad in bo._bsr_layout(seg):
            if b is not cur_b:
                cur_b = b
                sid_full = b.strip_ids.cpu().numpy().astype(np.int64)
            sid = np.zeros(n_pad, np.int64)
            sid[: s1 - s0] = sid_full[s0:s1]
            valid = np.zeros(n_pad, bool)
            valid[: s1 - s0] = sid_full[s0:s1] < nsp
            sids.append(sid)
            valids.append(valid)
    rid_all = np.concatenate(sids) if sids else np.zeros((0,), np.int64)
    valid_all = np.concatenate(valids) if valids else np.zeros((0,), bool)
    classes, widths, rowpos = _classes_from_slots(rid_all, valid_all, nsp)

    # slot position of each strip's m-th part, for the row-granular sum
    n_slots = len(rid_all)
    pos_all = np.nonzero(valid_all)[0]
    strips = rid_all[pos_all]
    order = np.argsort(strips, kind="stable")
    ss, ps = strips[order], pos_all[order]
    counts = np.bincount(ss.astype(np.int64), minlength=nsp)
    starts = np.zeros(nsp, np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    maxm = int(counts.max()) if counts.size else 0
    slot_of_strip = np.full((max(maxm, 1), nsp), n_slots, np.int64)
    for m in range(maxm):
        sel = counts > m
        slot_of_strip[m, sel] = ps[starts[sel] + m]
    TM = A.segments[0].tile_m
    row_srcs = _row_positions(slot_of_strip, n_slots, TM, A.shape[0])
    return make_plan(classes, rowpos, widths, n_slots, colseg_layout_key(),
                     A.device or "cpu", row_srcs or (), TM)


def apply_plan(plan: AssemblyPlan, parts_cat):
    """parts_cat ``(n_slots, L)`` -> Y ``(nrow, L)`` of its dtype (f32, or
    f64 for a float64 product's segment parts) through the plan's gathers
    (no scatter)."""
    with tracing.span("assemble"):
        return sum_plan(plan, parts_cat)


def sum_plan(plan: AssemblyPlan, rows):
    """The plan's output rows summed from ``rows``, f32 (or f64) ``(n,
    L)``: the concatenated parts (a cross-segment plan's: per output row
    its strips' rows, ``n = n_slots·TM``, over ``row_srcs``; or whole
    strips of ``TM·Npad`` floats, over its classes). One `plan_sum`
    launch on the card; elsewhere the torch ops, the kernel's plain
    version."""
    if rows.is_cuda:
        return plan_sum(plan.row_ptr, plan.src, rows, plan.n_levels)
    return plain_sum(plan, rows)


def plain_sum(plan: AssemblyPlan, rows):
    """`sum_plan` by torch ops (the CPU path, and the plan kernel's oracle
    on the card): the class walk, or the ``row_srcs`` walk."""
    if plan.row_srcs:
        # the zero row and the concatenation, per level a cast and a
        # gather, and the adds
        tracing.count(3 * len(plan.row_srcs) + 1)
        pcat = torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])
        Y = pcat[plan.row_srcs[0].long()]
        for src in plan.row_srcs[1:]:
            Y = Y + pcat[src.long()]
        return Y
    # per class an index cast, w gathers and w - 1 adds; the zero row,
    # the concatenation, and the row order's cast and gather
    tracing.count(2 * sum(plan.widths) + 4)
    return _apply_plan(plan, rows)


def _apply_plan(plan, parts_cat):
    ys = []
    for c, pos_c in zip(plan.widths, plan.classes):
        pos = pos_c.long()
        yc = parts_cat[pos[:, 0]]
        for s in range(1, c):
            yc = yc + parts_cat[pos[:, s]]
        ys.append(yc)
    ys.append(parts_cat.new_zeros((1, parts_cat.shape[1])))
    return torch.cat(ys)[plan.rowpos.long()]
