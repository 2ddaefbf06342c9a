"""Carry a compiled operator's layout across packages as numpy arrays.

`reference_arrays` flattens an operator into a dict of numpy arrays and
static ints: for a mono BSR tiling the bucket arrays, the narrow halo
layout, shapes and tile sizes; for a tile-bucket or class-panel BSR
tiling every bucket's arrays (``strip_ids``, ``slab_ids`` and ``tiles``,
or ``strip_ids``, ``start_slab`` and ``panels``; bf16 values as f32 with
their dtype's name) and the strip plan; for a ColSegmented its segments,
offsets and cross-segment plan; for an ELL tiling (EllMatrix or
SegmentedEll) every bucket's ``row_ids``, ``cols``, ``vals``, ``packed``
and ``n_real`` and the assembly plan (f32 or f64 values); for a `DdEll`
its ``hi`` and ``lo`` planes, each an ELL tiling; for a HybridMatrix its
dense tiles,
its ELL part, its `DenseCols` block (``col_ids``, ``block``, ``shape``,
``nnz``, ``n_cols``), ``threshold`` and ``dense_nnz``; for a COO or CSR
tiling (valued or binary) its index arrays (``rows``, ``cols``, and
``row_ptr`` for CSR), values, ``n_valid`` and, for COO, ``row_sorted``,
padding included; and the operator's four permutations. It reads attributes only, so it
takes an operator of either package (the JAX reference's or this port's)
without importing the other. `operator_from_reference_arrays` rebuilds the
port's `SparseOperator` from such a dict on a given device; the tests use
the pair to run both packages on the identical layout.
"""
from __future__ import annotations

import numpy as np
import torch

from .formats.bsr import (
    BsrBucket, BsrMatrix, MonoGroupBucket, MonoPanelBucket, PanelBucket,
)
from .formats.coo import COO, BinaryCOO
from .formats.csr import CSR, BinaryCSR
from .formats.ell import DdEll, EllBucket, EllMatrix, SegmentedEll
from .formats.hybrid import DenseCols, HybridMatrix
from .formats.segmented import ColSegmented
from .linops import SparseOperator
from .ops.assemble import BsrStripPlan, make_plan

__all__ = ["reference_arrays", "operator_from_reference_arrays"]

_MATRIX_INTS = ("nnz", "n_tiles", "padded_tiles", "tile_m", "tile_k")
_PANEL_ARRAYS = ("strip_ids", "window", "start_rel", "first", "panels")
_PANEL_INTS = ("width", "win_slabs", "n_windows", "out_strips")
_GROUP_ARRAYS = ("windows", "start_rel", "panels")
_GROUP_INTS = ("width", "win_slabs", "n_windows", "group", "out_strips",
               "win_stride")
_ELL_INTS = ("nnz", "padded_nnz", "split_rows")
_BUCKET_ARRAYS = ("row_ids", "cols", "vals")
# COO/CSR containers by class name (the same in both packages)
_SCATTER = {"COO": COO, "BinaryCOO": BinaryCOO, "CSR": CSR,
            "BinaryCSR": BinaryCSR}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _vals(a):
    """(numpy array, dtype name) of a value array of either package; bf16
    values (exact in f32) travel as f32."""
    name = str(a.dtype).split(".")[-1]
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if name == "bfloat16" else a).numpy(), name
    a = np.asarray(a)
    return (a.astype(np.float32) if name == "bfloat16" else a), name


def _vals_from(d, key, device):
    return torch.as_tensor(np.array(d[key]), device=device).to(
        getattr(torch, d[key + ".dtype"]))


def _plan_arrays(plan, prefix, d):
    d[prefix + "has_plan"] = plan is not None
    if plan is None:
        return
    d[prefix + "plan.widths"] = tuple(int(w) for w in plan.widths)
    d[prefix + "plan.n_slots"] = int(plan.n_slots)
    d[prefix + "plan.layout_key"] = tuple(plan.layout_key)
    d[prefix + "plan.rowpos"] = _np(plan.rowpos)
    for k, c in enumerate(plan.classes):
        d[prefix + f"plan.class{k}"] = _np(c)
    row_srcs = getattr(plan, "row_srcs", ()) or ()
    d[prefix + "plan.n_row_srcs"] = len(row_srcs)
    for k, r in enumerate(row_srcs):
        d[prefix + f"plan.row_src{k}"] = _np(r)


def _strip_plan_arrays(plan, prefix, d):
    d[prefix + "has_strip_plan"] = plan is not None
    if plan is None:
        return
    d[prefix + "strip_plan.pos"] = _np(plan.pos)
    d[prefix + "strip_plan.n_parts"] = int(plan.n_parts)
    d[prefix + "strip_plan.layout_key"] = tuple(plan.layout_key)
    d[prefix + "strip_plan.row_pos"] = (
        None if plan.row_pos is None else _np(plan.row_pos))


def _bucket_arrays(A, prefix, d):
    """A tile-bucket / class-panel BsrMatrix's buckets and strip plan."""
    d[prefix + "kind"] = "bsr"
    d[prefix + "n_buckets"] = len(A.buckets)
    for i, b in enumerate(A.buckets):
        p = prefix + f"b{i}."
        d[p + "strip_ids"] = _np(b.strip_ids)
        if hasattr(b, "start_slab"):  # PanelBucket
            d[p + "start_slab"] = _np(b.start_slab)
            d[p + "panels"], d[p + "panels.dtype"] = _vals(b.panels)
            d[p + "width"] = int(b.width)
        else:
            d[p + "slab_ids"] = _np(b.slab_ids)
            d[p + "tiles"], d[p + "tiles.dtype"] = _vals(b.tiles)
            d[p + "ntiles"] = int(b.ntiles)
    _strip_plan_arrays(A.strip_plan, prefix, d)


def _ell_arrays(A, prefix, d):
    d[prefix + "kind"] = "ell"
    d[prefix + "shape"] = tuple(int(v) for v in A.shape)
    d[prefix + "unit_vals"] = bool(A.unit_vals)
    for k in _ELL_INTS:
        d[prefix + k] = int(getattr(A, k))
    d[prefix + "n_buckets"] = len(A.buckets)
    for i, b in enumerate(A.buckets):
        p = prefix + f"b{i}."
        for k in _BUCKET_ARRAYS:
            d[p + k] = _np(getattr(b, k))
        d[p + "width"] = int(b.width)
        d[p + "n_real"] = int(b.n_real)
        d[p + "has_packed"] = b.packed is not None
        if b.packed is not None:
            d[p + "packed"] = _np(b.packed).reshape(d[p + "cols"].shape[0], -1)
    _plan_arrays(A.plan, prefix, d)


_PERMS = ("row_perm", "col_perm", "row_inv", "col_inv")
_HYBRID_INTS = ("nnz", "dense_nnz", "threshold")


def _hybrid_arrays(A, prefix, d):
    d[prefix + "kind"] = "hybrid"
    d[prefix + "shape"] = tuple(int(v) for v in A.shape)
    for k in _HYBRID_INTS:
        d[prefix + k] = int(getattr(A, k))
    d[prefix + "has_dense"] = A.dense is not None
    if A.dense is not None:
        _matrix_arrays(A.dense, prefix + "dense.", d)
    d[prefix + "has_sparse"] = A.sparse is not None
    if A.sparse is not None:
        _matrix_arrays(A.sparse, prefix + "sparse.", d)
    dc = A.dense_cols
    d[prefix + "has_dense_cols"] = dc is not None
    if dc is not None:
        d[prefix + "dc.col_ids"] = _np(dc.col_ids)
        d[prefix + "dc.block"] = _np(dc.block)
        d[prefix + "dc.shape"] = tuple(int(v) for v in dc.shape)
        d[prefix + "dc.nnz"] = int(dc.nnz)
        d[prefix + "dc.n_cols"] = int(dc.n_cols)


def _scatter_arrays(A, prefix, d):
    kind = type(A).__name__
    d[prefix + "kind"] = kind
    d[prefix + "shape"] = tuple(int(v) for v in A.shape)
    d[prefix + "n_valid"] = int(A.n_valid)
    for k in ("row_ptr", "rows", "cols"):
        if hasattr(A, k):
            d[prefix + k] = _np(getattr(A, k))
    if kind in ("COO", "CSR"):
        d[prefix + "vals"], d[prefix + "vals.dtype"] = _vals(A.vals)
    if kind.endswith("COO"):
        d[prefix + "row_sorted"] = bool(A.row_sorted)


def _scatter_from(d, prefix, device):
    kind = d[prefix + "kind"]
    kw = {k: torch.as_tensor(np.array(d[prefix + k]), device=device)
          for k in ("row_ptr", "rows", "cols") if prefix + k in d}
    if kind in ("COO", "CSR"):
        kw["vals"] = _vals_from(d, prefix + "vals", device)
    if kind.endswith("COO"):
        kw["row_sorted"] = d[prefix + "row_sorted"]
    return _SCATTER[kind](shape=tuple(d[prefix + "shape"]),
                          n_valid=d[prefix + "n_valid"], **kw)


def _matrix_arrays(A, prefix, d):
    if type(A).__name__ in _SCATTER:
        _scatter_arrays(A, prefix, d)
        return
    if hasattr(A, "hi") and hasattr(A, "lo"):  # DdEll
        d[prefix + "kind"] = "dd"
        d[prefix + "shape"] = tuple(int(v) for v in A.shape)
        d[prefix + "nnz"] = int(A.nnz)
        _matrix_arrays(A.hi, prefix + "hi.", d)
        _matrix_arrays(A.lo, prefix + "lo.", d)
        return
    if hasattr(A, "dense_cols"):  # HybridMatrix
        _hybrid_arrays(A, prefix, d)
        return
    if type(A).__name__ == "ColSegmented":
        d[prefix + "kind"] = "colseg"
        d[prefix + "shape"] = tuple(int(v) for v in A.shape)
        d[prefix + "nnz"] = int(A.nnz)
        d[prefix + "seg_cols"] = int(A.seg_cols)
        d[prefix + "col_offsets"] = tuple(int(v) for v in A.col_offsets)
        for i, seg in enumerate(A.segments):
            _matrix_arrays(seg, prefix + f"seg{i}.", d)
        _plan_arrays(A.plan, prefix, d)
        return
    if hasattr(A, "col_offsets"):  # SegmentedEll
        d[prefix + "kind"] = "ell-seg"
        d[prefix + "shape"] = tuple(int(v) for v in A.shape)
        d[prefix + "nnz"] = int(A.nnz)
        d[prefix + "seg_cols"] = int(A.seg_cols)
        d[prefix + "col_offsets"] = tuple(int(v) for v in A.col_offsets)
        for i, seg in enumerate(A.segments):
            _ell_arrays(seg, prefix + f"seg{i}.", d)
        _plan_arrays(A.plan, prefix, d)
        return
    if hasattr(A, "unit_vals"):  # EllMatrix
        _ell_arrays(A, prefix, d)
        return
    d[prefix + "shape"] = tuple(int(v) for v in A.shape)
    d[prefix + "binary"] = bool(A.binary)
    for k in _MATRIX_INTS:
        d[prefix + k] = int(getattr(A, k))
    if not A.buckets:
        d[prefix + "kind"] = "empty"
        return
    if not A.is_mono:
        _bucket_arrays(A, prefix, d)
        return
    if A.is_mono_grouped or len(A.buckets) != 1:
        raise NotImplementedError("only single-bucket mono layouts carry over")
    d[prefix + "kind"] = "mono"
    b = A.buckets[0]
    for k in _PANEL_ARRAYS:
        d[prefix + k] = _np(getattr(b, k))
    for k in _PANEL_INTS:
        d[prefix + k] = int(getattr(b, k))
    n = getattr(A, "narrow", None)
    d[prefix + "has_narrow"] = n is not None
    if n is not None:
        for k in _GROUP_ARRAYS:
            d[prefix + "narrow." + k] = _np(getattr(n, k))
        for k in _GROUP_INTS:
            d[prefix + "narrow." + k] = int(getattr(n, k))


def reference_arrays(op) -> dict:
    """Flatten a BSR, ELL, dd, hybrid, COO or CSR operator (either
    package) into a dict of numpy arrays and static ints, keyed ``fwd.*``
    and ``bwd.*``, with the permutations (None or int32 arrays) under their
    names."""
    d = {"shape": tuple(int(v) for v in op.shape),
         "has_bwd": op.bwd is not None}
    for k in _PERMS:
        p = getattr(op, k, None)
        d[k] = None if p is None else _np(p).astype(np.int32)
    _matrix_arrays(op.fwd, "fwd.", d)
    if op.bwd is not None:
        _matrix_arrays(op.bwd, "bwd.", d)
    return d


def _plan_from(d, prefix, device, tile_m=None):
    """The plan under ``prefix``; ``tile_m``: a ColSegmented's strip height
    (its ``row_srcs`` index the parts' rows, the last one the zero row)."""
    if not d[prefix + "has_plan"]:
        return None
    p = prefix + "plan."
    widths, n_slots = d[p + "widths"], d[p + "n_slots"]
    return make_plan(
        [np.array(d[p + f"class{k}"]) for k in range(len(widths))],
        np.array(d[p + "rowpos"]), widths, n_slots, d[p + "layout_key"],
        device, [np.array(d[p + f"row_src{k}"])
                 for k in range(d[p + "n_row_srcs"])],
        tile_m,
    )


def _ell_from(d, prefix, device) -> EllMatrix:
    buckets = []
    for i in range(d[prefix + "n_buckets"]):
        p = prefix + f"b{i}."
        t = {k: torch.as_tensor(np.array(d[p + k]), device=device)
             for k in _BUCKET_ARRAYS}
        packed = None
        if d[p + "has_packed"]:
            packed = torch.as_tensor(np.array(d[p + "packed"]), device=device)
        buckets.append(EllBucket(width=d[p + "width"], n_real=d[p + "n_real"],
                                 packed=packed, **t))
    return EllMatrix(
        buckets=tuple(buckets), shape=tuple(d[prefix + "shape"]),
        unit_vals=d[prefix + "unit_vals"], plan=_plan_from(d, prefix, device),
        **{k: d[prefix + k] for k in _ELL_INTS},
    )


def _hybrid_from(d, prefix, device) -> HybridMatrix:
    dense = sparse = dc = None
    if d[prefix + "has_dense"]:
        dense = _matrix_from(d, prefix + "dense.", device)
    if d[prefix + "has_sparse"]:
        sparse = _matrix_from(d, prefix + "sparse.", device)
    if d[prefix + "has_dense_cols"]:
        dc = DenseCols(
            col_ids=torch.as_tensor(np.array(d[prefix + "dc.col_ids"]),
                                    device=device),
            block=torch.as_tensor(np.array(d[prefix + "dc.block"]),
                                  device=device),
            shape=tuple(d[prefix + "dc.shape"]), nnz=d[prefix + "dc.nnz"],
            n_cols=d[prefix + "dc.n_cols"],
        )
    return HybridMatrix(dense=dense, sparse=sparse, dense_cols=dc,
                        shape=tuple(d[prefix + "shape"]),
                        **{k: d[prefix + k] for k in _HYBRID_INTS})


def _matrix_from(d, prefix, device):
    kind = d[prefix + "kind"]
    if kind in _SCATTER:
        return _scatter_from(d, prefix, device)
    if kind == "dd":
        return DdEll(hi=_matrix_from(d, prefix + "hi.", device),
                     lo=_matrix_from(d, prefix + "lo.", device),
                     shape=tuple(d[prefix + "shape"]), nnz=d[prefix + "nnz"])
    if kind == "hybrid":
        return _hybrid_from(d, prefix, device)
    if kind == "ell":
        return _ell_from(d, prefix, device)
    if kind == "colseg":
        offsets = d[prefix + "col_offsets"]
        segs = tuple(_matrix_from(d, prefix + f"seg{i}.", device)
                     for i in range(len(offsets)))
        tile_m = getattr(segs[0], "tile_m", None) if segs else None
        return ColSegmented(
            segments=segs,
            col_offsets=tuple(offsets), seg_cols=d[prefix + "seg_cols"],
            shape=tuple(d[prefix + "shape"]), nnz=d[prefix + "nnz"],
            plan=_plan_from(d, prefix, device, tile_m),
        )
    if kind == "ell-seg":
        offsets = d[prefix + "col_offsets"]
        return SegmentedEll(
            segments=tuple(_ell_from(d, prefix + f"seg{i}.", device)
                           for i in range(len(offsets))),
            col_offsets=tuple(offsets), seg_cols=d[prefix + "seg_cols"],
            shape=tuple(d[prefix + "shape"]), nnz=d[prefix + "nnz"],
            plan=_plan_from(d, prefix, device),
        )
    return _bsr_from(d, prefix, device)


def _bucket_from(d, p, device):
    def t(k):
        return torch.as_tensor(np.array(d[p + k]), device=device)

    if p + "start_slab" in d:
        return PanelBucket(strip_ids=t("strip_ids"), start_slab=t("start_slab"),
                           panels=_vals_from(d, p + "panels", device),
                           width=d[p + "width"])
    return BsrBucket(strip_ids=t("strip_ids"), slab_ids=t("slab_ids"),
                     tiles=_vals_from(d, p + "tiles", device),
                     ntiles=d[p + "ntiles"])


def _strip_plan_from(d, prefix, device):
    if not d[prefix + "has_strip_plan"]:
        return None
    p = prefix + "strip_plan."
    row_pos = d[p + "row_pos"]
    return BsrStripPlan(
        pos=torch.as_tensor(np.array(d[p + "pos"]), device=device),
        n_parts=d[p + "n_parts"], layout_key=tuple(d[p + "layout_key"]),
        row_pos=None if row_pos is None else torch.as_tensor(
            np.array(row_pos), device=device),
    )


def _bsr_from(d, prefix, device) -> BsrMatrix:
    def t(k, dtype=None):
        return torch.as_tensor(np.array(d[prefix + k]), dtype=dtype,
                               device=device)

    buckets, narrow, strip_plan = (), None, None
    if d[prefix + "kind"] == "bsr":
        buckets = tuple(_bucket_from(d, prefix + f"b{i}.", device)
                        for i in range(d[prefix + "n_buckets"]))
        strip_plan = _strip_plan_from(d, prefix, device)
    if d[prefix + "kind"] == "mono":
        panels = t("panels")
        buckets = (MonoPanelBucket.from_items(
            *(d[prefix + k] for k in _PANEL_ARRAYS[:4]), panels,
            **{k: d[prefix + k] for k in _PANEL_INTS},
        ),)
        if d[prefix + "has_narrow"]:
            p = prefix + "narrow."
            narrow = MonoGroupBucket(
                windows=t("narrow.windows", torch.int32),
                start_rel=t("narrow.start_rel", torch.int32),
                panels=t("narrow.panels"),
                **{k: int(d[p + k]) for k in _GROUP_INTS},
            )
    return BsrMatrix(
        buckets=buckets,
        shape=tuple(d[prefix + "shape"]),
        binary=bool(d[prefix + "binary"]),
        strip_plan=strip_plan,
        narrow=narrow,
        **{k: int(d[prefix + k]) for k in _MATRIX_INTS},
    )


def operator_from_reference_arrays(d: dict, device="cuda") -> SparseOperator:
    """The port's `SparseOperator` holding exactly the layout in ``d``
    (as made by `reference_arrays`), on ``device``."""
    fwd = _matrix_from(d, "fwd.", device)
    bwd = _matrix_from(d, "bwd.", device) if d["has_bwd"] else None
    perms = {k: None if d.get(k) is None
             else torch.as_tensor(np.array(d[k]), device=device)
             for k in _PERMS}
    return SparseOperator(fwd=fwd, bwd=bwd, shape=tuple(d["shape"]), **perms)
