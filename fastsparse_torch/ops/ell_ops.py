"""ELL gather-engine dispatch (counterpart of ``fastsparse/ops/ell_ops.py``).

Bridges `formats.ell` to the gather kernels (`ops.kernels.ell_spmm`): pads
each column segment's X panel (a zero sentinel row past its columns),
walks the part-slot layout `_seg_layout` (bucket chunks, merged packed
sweeps and, with ``USE_SMEM_PATH``, whole buckets), and assembles Y
through the build-time gather plan (`ops.assemble`) or, without one, a
row ``index_add_``. At X widths of at most ``TABLE_MAX_LANES`` lanes (SpMV
and the narrow CG widths) every part of every segment runs in one launch,
`ell_table_spmm`, over a tile table built from the layout at the first
such call and kept on the matrix (`formats.ell.EllMatrix.tables`), the X
panels written into one buffer; wider X, and every width under
``USE_SMEM_PATH``, launches one kernel per part. A float64 product (f64
values, or 0/1 values under an f64 X) runs the table's f64 mode on the
card at those widths, native f64 arithmetic in the same order, its
segments' parts summed by an assembly plan built with the table
(`gather_engine_supported`); wider, and on the CPU, it keeps the
reference's per-bucket scan (`ops.spmm`, span ``ell_scan``).

The budgets and flags below are the reference's layout parameters, kept
as module attributes of the same names so tests can monkeypatch them in
both packages: they fix which slots share a launch, and so the plan, not
anything of this card (one bucket row's sum never crosses a chunk).
``USE_SMEM_PATH`` (off by default, as in the reference) sends every
bucket past its chunk budget, up to ``SMEM_BLOCK_K_*`` wide, to the
one-launch kernel `ell_bucket_spmm_smem`.

`ell_spmm_dd` is the fp64-class product (unit ELL or `DdEll`) through the
double-word gather kernels (`ops.kernels.ell_dd`).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .. import tracing
from ..formats.ell import EllMatrix, SegmentedEll
from . import assemble as _assemble
from .kernels.ell_spmm import (
    ELL_GROUP,
    SMEM_BLOCK_K_UNIT,
    SMEM_BLOCK_K_VALUED,
    TABLE_MAX_LANES,
    EllPart,
    _body_mode,
    ell_bucket_spmm,
    ell_bucket_spmm_smem,
    ell_sweep_spmm,
    ell_table,
    ell_table_spmm,
    packed_pair_ok,
)

__all__ = ["ell_spmm", "ell_spmm_dd", "gather_engine_supported",
           "gather_engine_fits"]

LANES = 128
# flat entries per launch in the reference (its SMEM scalar-prefetch budget)
_SMEM_IDX_BUDGET_UNIT = 128 * 1024
_SMEM_IDX_BUDGET_VALUED = 64 * 1024
# one launch per whole bucket past the chunk budget (`ell_bucket_spmm_smem`)
USE_SMEM_PATH = False
# merge packed width-class chunks into multi-part sweep launches
USE_SWEEP = True
# the reference's X-panel residency budget (`gather_engine_fits`)
X_VMEM_BUDGET = 12 * 1024 * 1024


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def gather_engine_supported(dtype, A, X) -> bool:
    """Whether `ell_spmm` takes a product of ``dtype`` over ``A`` with
    operand ``X``: float32 at every width; float64 on the one-launch table
    path only (its f64 mode): at most ``TABLE_MAX_LANES`` lanes of a CUDA
    ``X``, not under ``USE_SMEM_PATH``, over f64 or 0/1 values. Wider f64
    X, and the CPU, keep the reference's scan."""
    if dtype == torch.float32:
        return True
    if dtype != torch.float64 or not X.is_cuda:
        return False
    n = X.shape[1] if X.ndim > 1 else 1
    return (_lanes(n) <= TABLE_MAX_LANES and not USE_SMEM_PATH
            and all(s.unit_vals or s.dtype == torch.float64
                    for _, s in _segments(A)))


def gather_engine_fits(ncol: int, n_rhs: int, itemsize: int = 4) -> bool:
    """The reference's test that one 128-lane X panel stays resident; the
    dispatch keeps it so both packages take the same engine."""
    nb = min(_round_up(max(n_rhs, 1), LANES), 512)
    nb = min(nb, LANES)
    return _round_up(max(ncol, 8), 8) * nb * itemsize <= X_VMEM_BUDGET


def _chunk_ranges(nb: int, K: int, budget: int):
    """Slot ranges (s0, s1, n_pad) covering a bucket under the budget; the
    tail chunk keeps its own 8-row-rounded height."""
    nb_max = max(ELL_GROUP, (budget // max(K, 1)) // 8 * 8)
    if nb <= nb_max:
        yield 0, nb, nb
        return
    for s0 in range(0, nb, nb_max):
        s1 = min(s0 + nb_max, nb)
        yield s0, s1, min(-(-(s1 - s0) // 8) * 8, nb_max)


def _seg_layout(seg, budget=None):
    """THE part-slot layout of one segment, consumed by the compute path
    (`_seg_parts`), the plan builder (`ops.assemble._slot_stream`) and the
    tests. Yields per appended part ``(bucket, mode, s0, s1, n_pad)``:
    "chunk" (slots [s0, s1) padded to n_pad rows), "smem" (a whole bucket)
    or, for packed sub-parts merged into one launch,
    ``(subparts, "sweep", 0, 0, 0)`` with ``subparts`` a tuple of
    ``(bucket, s0, s1, n_pad)``. A ``budget`` override always chunks."""
    unit = seg.unit_vals
    b_eff = (
        budget
        if budget is not None
        else (_SMEM_IDX_BUDGET_UNIT if unit else _SMEM_IDX_BUDGET_VALUED)
    )
    k_cap = SMEM_BLOCK_K_UNIT if unit else SMEM_BLOCK_K_VALUED
    # packed-pair buckets take half the index words per slot: their
    # budget doubles (the kernel applies the same test)
    rows_pad = _round_up(max(seg.shape[1] + 1, 8), 8)
    pend, pend_entries = [], 0  # sweep accumulator (packed sub-parts)
    cap_entries = 2 * b_eff if USE_SWEEP else 0

    def flush():
        nonlocal pend, pend_entries
        if len(pend) == 1:
            b_, s0_, s1_, n_ = pend[0]
            yield b_, "chunk", s0_, s1_, n_
        elif pend:
            yield tuple(pend), "sweep", 0, 0, 0
        pend, pend_entries = [], 0

    for b in seg.buckets:
        nb, K = b.cols.shape
        pair_ok = budget is None and unit and packed_pair_ok(K, rows_pad)
        packable = pair_ok and b.packed is not None
        b_bucket = 2 * b_eff if pair_ok else b_eff
        if budget is None and USE_SMEM_PATH and nb * K > b_bucket and K <= k_cap:
            yield from flush()
            yield b, "smem", 0, nb, nb
            continue
        for s0, s1, n_pad in _chunk_ranges(nb, K, b_bucket):
            if not packable:
                yield from flush()
                yield b, "chunk", s0, s1, n_pad
                continue
            if pend_entries + n_pad * K > cap_entries:
                yield from flush()
            pend.append((b, s0, s1, n_pad))
            pend_entries += n_pad * K
    yield from flush()


def _slice_chunk(b, ell, s0, s1, n_pad):
    """Bucket slots [s0, s1) padded to n_pad rows (padding rows: zero
    values, sentinel columns). Returns ``(row_ids, cols, vals, packed)``."""
    nb, K = b.cols.shape
    pk = b.packed
    if (s0, s1, n_pad) == (0, nb, nb):
        return b.row_ids, b.cols, b.vals, pk
    rid, cc, vv = b.row_ids[s0:s1], b.cols[s0:s1], b.vals[s0:s1]
    pp = None if pk is None else pk[s0:s1]
    if s1 - s0 < n_pad:
        tracing.count(6 if pk is None else 8)
        pad = n_pad - (s1 - s0)
        pad_col = ell.shape[1] if ell.unit_vals else 0
        rid = torch.cat([rid, rid.new_zeros(pad)])
        cc = torch.cat([cc, cc.new_full((pad, K), pad_col)])
        vv = torch.cat([vv, vv.new_zeros((pad, K))])
        if pp is not None:
            # packed sentinel pair: both halves the sentinel column
            pad_p = pad_col | (pad_col << 16)
            pad_p = pad_p - 2**32 if pad_p >= 2**31 else pad_p
            pp = torch.cat([pp, pp.new_full((pad, K // 2), pad_p)])
    return rid, cc, vv, pp


def _seg_parts(ell: EllMatrix, Xseg, rids, parts):
    """Append one segment's per-part products to (rids, parts), one kernel
    launch per layout item, in layout order (each counted ``ell_launch``)."""
    unit = ell.unit_vals
    for b, mode, s0, s1, n_pad in _seg_layout(ell):
        tracing.count(1, "ell_launch")
        if mode == "sweep":
            flats, rid_l, meta = [], [], []
            for bb, t0, t1, np_ in b:
                rid, _cc, _vv, pp = _slice_chunk(bb, ell, t0, t1, np_)
                flats.append(pp.reshape(-1))
                rid_l.append(rid)
                meta.append((np_, bb.cols.shape[1] // 2))
            tracing.count(2)
            parts.append(ell_sweep_spmm(torch.cat(flats), Xseg,
                                        parts=tuple(meta)))
            rids.append(torch.cat(rid_l))
            continue
        if mode == "smem":
            # the whole bucket in one launch, over plain columns
            parts.append(ell_bucket_spmm_smem(b.cols, b.vals, Xseg,
                                              unit=unit))
            rids.append(b.row_ids)
            continue
        row_ids, cols, vals, packed = _slice_chunk(b, ell, s0, s1, n_pad)
        parts.append(ell_bucket_spmm(cols, vals, Xseg, unit=unit,
                                     packed=packed))
        rids.append(row_ids)  # padding rows add zeros


def _lanes(N: int) -> int:
    """X and part lanes: N rounded up to 4 (16-byte rows) from N = 4 on."""
    return N if N < 4 else _round_up(N, 4)


def ell_spmm(A, X):
    """``Y = A @ X`` through the gather kernels. A: EllMatrix or
    SegmentedEll; X ``(ncol, N)`` on A's device. Products in float32, or
    in float64 (f64 values or X: the table path's f64 mode, at most
    ``TABLE_MAX_LANES`` lanes), in the promoted dtype."""
    dt = torch.promote_types(A.dtype, X.dtype)
    with tracing.span("ell_ops", dtype=str(dt).removeprefix("torch.")):
        return _ell_spmm(A, X, dt)


def _table_parts(A):
    """``(parts, row_ids, panels, x_rows)`` of a narrow product over A: an
    `EllPart` per bucket chunk and sweep sub-part in `_seg_layout`'s order
    (each with the body its per-part kernel runs: `_body_mode`'s, the
    whole-row packed body for a sweep's) and its bucket's row ids, and per
    segment ``(first column, columns, first X row)`` of its panel in one X
    buffer of ``x_rows`` rows."""
    parts, row_ids, panels, x_rows = [], [], [], 0
    for off, seg in _segments(A):
        unit = seg.unit_vals
        rows_pad = _round_up(max(seg.shape[1] + 1, 8), 8)
        panels.append((off, seg.shape[1], x_rows))
        for b, mode, s0, s1, n_pad in _seg_layout(seg):
            sweep = mode == "sweep"
            for bb, t0, t1, np_ in b if sweep else ((b, s0, s1, n_pad),):
                K = bb.cols.shape[1]
                KB, full, packed = ((K, True, True) if sweep
                                    else _body_mode(K, rows_pad, unit))
                # pairs where the layout has them (plain columns add the
                # same entries in the same order)
                packed = packed and bb.packed is not None
                idx = (bb.packed.reshape(bb.cols.shape[0], K // 2) if packed
                       else bb.cols)
                parts.append(EllPart(idx, None if unit else bb.vals, t0,
                                     t1 - t0, np_, K, KB, full, packed,
                                     x_rows))
                row_ids.append(bb.row_ids)
        x_rows += rows_pad
    return parts, tuple(row_ids), tuple(panels), x_rows


class _Narrow(NamedTuple):
    table: Any  # `ell_table`'s
    row_ids: tuple  # each part's bucket row ids
    panels: tuple  # (first column, columns, first X row) per segment
    plan: Any = None  # f64: the slot stream's assembly plan


def _narrow(A, L, device, dtype=torch.float32) -> _Narrow:
    """A's tile table at L lanes for products of ``dtype``, built at the
    first narrow call under the current layout parameters and kept on A.
    At f64 it carries the slot stream's assembly plan
    (`ops.assemble.build_assembly_plan`; the build attaches plans to f32
    layouts only): each output row its parts' sum, in segment order."""
    key = (L, _assemble.layout_key(), dtype)
    got = A.tables.get(key)
    if got is None:
        parts, row_ids, panels, x_rows = _table_parts(A)
        unit = all(s.unit_vals for _, s in _segments(A))
        table = ell_table(parts, L, unit, x_rows, device, dtype)
        plan = None
        if dtype == torch.float64:
            plan = _assemble.build_assembly_plan(A)
            if plan.row_ptr.is_cuda:  # its arrays' copies to the card
                tracing.count(len(plan.classes) + 3)
        got = _Narrow(table, row_ids, panels, plan)
        A.tables[key] = got
    return got


def _slot_rows(nw: _Narrow):
    """int64 output row of each slot of the table's stream (padding rows
    row 0, adding zeros), for a product without a plan."""
    pieces = []
    for pt, rid in zip(nw.table.parts, nw.row_ids):
        pieces.append(rid[pt.row0 : pt.row0 + pt.n_src])
        if pt.n_rows > pt.n_src:
            pieces.append(rid.new_zeros(pt.n_rows - pt.n_src))
            tracing.count()
    tracing.count(2)
    return torch.cat(pieces).long()


def _table_product(A, X, L, dt=torch.float32):
    """``A @ X`` at L <= TABLE_MAX_LANES lanes in ``dt`` (f32, or f64):
    one zero fill of the X buffer and a copy per segment's panel (an f32
    X widens to f64 in the copy, exactly), one `ell_table_spmm` launch
    (counted ``ell_launch``) into the slot stream, the plan's sum."""
    nrow = A.shape[0]
    N = X.shape[1]
    nw = _narrow(A, L, X.device, dt)
    table = nw.table
    if not table.n_slots:
        tracing.count()
        return torch.zeros((nrow, L), dtype=dt, device=X.device)[:, :N]
    x = torch.zeros((table.x_rows, L), dtype=dt, device=X.device)
    for off, ncol, x0 in nw.panels:
        x[x0 : x0 + ncol, :N] = X[off : off + ncol]
    tracing.count(1 + len(nw.panels))
    tracing.count(1, "ell_launch")
    out = ell_table_spmm(table, x)
    plan = nw.plan if nw.plan is not None else A.plan
    if (plan is not None and plan.layout_key == _assemble.layout_key()
            and plan.n_slots == table.n_slots):
        return _assemble.apply_plan(plan, out)[:, :N]
    Y = torch.zeros((nrow, L), dtype=torch.float32, device=X.device)
    Y.index_add_(0, _slot_rows(nw), out)
    tracing.count(2)
    return Y[:, :N]


def _ell_spmm(A, X, dt):
    nrow, ncol = A.shape
    N = X.shape[1]
    L = _lanes(N)
    if L <= TABLE_MAX_LANES and not USE_SMEM_PATH:
        return _table_product(A, X, L, dt)
    if dt != torch.float32:
        raise ValueError(f"ell_spmm: a {dt} product runs on the table path "
                         f"only (at most {TABLE_MAX_LANES} lanes, no "
                         "USE_SMEM_PATH)")
    segs = _segments(A)
    rids, parts = [], []
    for off, seg in segs:
        seg_ncol = seg.shape[1]
        # +1: the unit-mode sentinel column (ncol) must hit a zero X row
        rows_pad = _round_up(max(seg_ncol + 1, 8), 8)
        Xseg = torch.zeros((rows_pad, L), dtype=torch.float32, device=X.device)
        Xseg[:seg_ncol, :N] = X[off : off + seg_ncol]
        tracing.count(2)
        _seg_parts(seg, Xseg, rids, parts)
    plan = A.plan
    if (
        parts
        and plan is not None
        and plan.layout_key == _assemble.layout_key()
        and plan.n_slots == sum(int(p.shape[0]) for p in parts)
    ):
        tracing.count()
        return _assemble.apply_plan(plan, torch.cat(parts))[:, :N]
    Y = torch.zeros((nrow, L), dtype=torch.float32, device=X.device)
    tracing.count(5 if parts else 1)
    if parts:
        Y.index_add_(0, torch.cat(rids).long(), torch.cat(parts))
    return Y[:, :N]


# ------------------------------------------------- fp64-class (dd) products
def _dd_add(ah, al, bh, bl, folded=False):
    """Elementwise double-word addition (TwoSum, then renormalise), f32,
    ``b`` being one segment's sums, in the order the reference's compiled
    program adds them (`ell_spmm_dd`'s merge). Its source reads
    ``lo = al + bl + e``, and that is what the first merge computes; in
    every later merge ``bl`` is a scatter-add into zeros whose one consumer
    is that sum, XLA's algebraic simplifier folds the adds into the
    scatter, and the program computes ``(al + e) + bl`` (``folded``; seen
    in its optimised HLO, and bit for bit under strict f32). Both are
    double-word sums of the same accuracy."""
    s = ah + bh
    v = s - ah
    e = (ah - (s - v)) + (bh - v)
    lo = (al + e) + bl if folded else (al + bl) + e
    hi = s + lo
    return hi, lo - (hi - s)


def _dd_panel(xh, xl, off, seg_ncol):
    """One segment's f32 operand panel: its hi plane in rows [0, rows_pad),
    its lo plane in rows [rows_pad, 2·rows_pad), each zero past the
    segment's columns (the unit sentinel ``seg_ncol`` reads zeros in
    both)."""
    rows_pad = _round_up(max(seg_ncol + 1, 8), 8)
    x2 = xh.new_zeros((2 * rows_pad, xh.shape[1]))
    x2[:seg_ncol] = xh[off : off + seg_ncol]
    x2[rows_pad : rows_pad + seg_ncol] = xl[off : off + seg_ncol]
    return x2


def _dd_segment(buckets, x2, nrow):
    """One segment's (Shi, Slo): one kernel launch per bucket (``buckets``
    holds ``(bucket, lo_bucket)`` pairs, ``lo_bucket`` None for unit
    values), the bucket rows added into zeros at their row ids. Within a
    segment every real row sits in one bucket row, so each add is exact;
    padding rows add zeros."""
    from .kernels.ell_dd import ell_bucket_spmm_dd, ell_bucket_spmm_dd_valued

    rids, yhs, yls = [], [], []
    for b, bl in buckets:
        if bl is None:
            yh, yl = ell_bucket_spmm_dd(b.cols, x2)
        else:
            yh, yl = ell_bucket_spmm_dd_valued(b.cols, b.vals, bl.vals, x2)
        rids.append(b.row_ids)
        yhs.append(yh)
        yls.append(yl)
    Shi = x2.new_zeros((nrow, x2.shape[1]))
    Slo = x2.new_zeros((nrow, x2.shape[1]))
    if rids:
        r = torch.cat(rids).long()
        Shi.index_add_(0, r, torch.cat(yhs))
        Slo.index_add_(0, r, torch.cat(yls))
    return Shi, Slo


def _f64_operand(X, device):
    """X as a float64 tensor: a tensor keeps its device, an array goes to
    ``device`` (the layout's)."""
    return torch.as_tensor(X, dtype=torch.float64,
                           device=None if torch.is_tensor(X) else device)


def _segments(A):
    if isinstance(A, SegmentedEll):
        return list(zip(A.col_offsets, A.segments))
    return [(0, A)]


def ell_spmm_dd(A, X):
    """fp64-class ``Y = A @ X`` from f32 arithmetic: a float64 ``(nrow,
    N)`` tensor on X's device.

    ``A``: a unit-values EllMatrix / SegmentedEll (the `ell_bucket_spmm_dd`
    kernel, TwoSum chains) or a `formats.ell.DdEll` (valued, the
    `ell_bucket_spmm_dd_valued` kernel, Dekker TwoProd); ``X`` float64
    ``(ncol, N)`` (a tensor, or an array put on A's device). X is split on
    the device, ``xh = f32(X)``, ``xl = f32(X - xh)``; each segment's
    (hi, lo) sums are merged in segment order by `_dd_add`, the first
    taken as it is, and the result is ``f64(hi) + f64(lo)``: the
    reference's arithmetic step for step as its compiled program runs it,
    rel ~1e-13 against a true f64 product.

    Interface difference: the reference returns numpy after one fetch;
    this returns a tensor and leaves it on the device. The reference
    chunks each bucket's launch to its SMEM index budget
    (``_SMEM_IDX_BUDGET_DD``); a row's sum never crosses a chunk, so the
    port launches once per bucket with the same result."""
    from ..formats.ell import DdEll

    valued = isinstance(A, DdEll)
    src = A.hi if valued else A
    X = _f64_operand(X, src.device)
    nrow = A.shape[0]
    if valued:
        segs = [(off, list(zip(sh.buckets, sl.buckets)), sh)
                for (off, sh), (_, sl) in zip(_segments(A.hi),
                                              _segments(A.lo))]
    else:
        segs = []
        for off, seg in _segments(A):
            if not getattr(seg, "unit_vals", False):
                raise ValueError(
                    "ell_spmm_dd requires a binary (unit) matrix")
            if seg.split_rows:
                # exactness depends on one bucket row per matrix row per
                # segment: split sub-row partials would merge through a
                # plain f32 add and lose the compensated low words
                raise ValueError(
                    "ell_spmm_dd requires an unsplit layout: rebuild with "
                    "build_ell(..., split_rows=0) (the fp64-class compile "
                    "paths do this automatically)")
            segs.append((off, [(b, None) for b in seg.buckets], seg))
    xh = X.float()
    xl = (X - xh.double()).float()
    Yhi = Ylo = None
    for i, (off, buckets, seg) in enumerate(segs):
        x2 = _dd_panel(xh, xl, off, seg.shape[1])
        Shi, Slo = _dd_segment(buckets, x2, nrow)
        if Yhi is None:
            Yhi, Ylo = Shi, Slo
        else:
            Yhi, Ylo = _dd_add(Yhi, Ylo, Shi, Slo, folded=i > 1)
    if Yhi is None:
        return X.new_zeros((nrow, X.shape[1]))
    return Yhi.double() + Ylo.double()
