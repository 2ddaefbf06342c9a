"""Bucketed ELL execution format (counterpart of ``fastsparse/formats/ell.py``).

Rows are bucketed by padded length instead of pointer-chased: each bucket
is a dense ``(nb, K)`` index/value pair, ``nb`` a multiple of 8. Bucket
membership is decided on the host (numpy) and reproduces the reference's
exactly: the sub-row split, the width ladder (even widths for packable
binary builds), the ×8 bucket rounding, the sentinel padding of binary
matrices and the build-time packed column pairs. The entry fill is one
``index_put_`` on the target device.

Layout per bucket (width K):

* ``row_ids int32[nb]`` — original row of each bucket slot (padding slots
  point at row 0 and add zeros);
* ``cols int32[nb, K]`` — column of each entry (padding: 0, or the
  sentinel ``ncol`` for binary matrices, a zero row of the padded X);
* ``vals f32[nb, K]`` — values (padding 0; unit values for binary);
* ``packed int32[nb, K/2]`` — ``c0 | c1<<16`` pairs of binary buckets
  with even K and 16-bit columns, else None.

`DdEll` / `build_ell_dd` hold a valued f64 matrix as two structure-equal
builds whose f32 value planes satisfy ``hi + lo == v`` to ~2^-48 (the
operands of the fp64-class gather, `ops.ell_ops.ell_spmm_dd`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from ..config import DEFAULT, Config
from .coo import COO, BinaryCOO
from .convert import to_csr_host
from .csr import CSR, BinaryCSR

__all__ = [
    "EllBucket",
    "EllMatrix",
    "SegmentedEll",
    "DdEll",
    "build_ell",
    "build_ell_segmented",
    "build_ell_dd",
]


def _ceil_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (int(x) - 1).bit_length()


def _round_up8(x: int) -> int:
    return -(-int(x) // 8) * 8


@dataclasses.dataclass(frozen=True)
class EllBucket:
    row_ids: torch.Tensor  # int32[nb]
    cols: torch.Tensor  # int32[nb, K]
    vals: torch.Tensor  # dtype[nb, K]
    width: int  # K
    n_real: int  # slots [0, n_real) hold real rows
    packed: Any = None  # int32[nb, K/2] build-time column pairs, or None


@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """A matrix compiled into width-bucketed ELL slabs. ``unit_vals=True``
    marks binary matrices (unit values, sentinel padding columns).
    ``split_rows > 0``: rows longer than that were split into several
    bucket rows sharing a row id (the assembly sums them). ``plan``: the
    gather-plan Y assembly (`ops.assemble.AssemblyPlan`), or None."""

    buckets: Tuple[EllBucket, ...]
    shape: tuple
    nnz: int
    padded_nnz: int  # sum of nb·K over buckets
    unit_vals: bool = False
    split_rows: int = 0
    plan: Any = None
    # the narrow products' tile tables, built at first use
    # (`ops.ell_ops`); a replaced copy starts empty
    tables: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False)

    @property
    def dtype(self):
        return self.buckets[0].vals.dtype if self.buckets else torch.float32

    @property
    def device(self):
        return self.buckets[0].row_ids.device if self.buckets else None

    def todense(self) -> torch.Tensor:
        dev = self.device or "cpu"
        out = torch.zeros(self.shape, dtype=self.dtype, device=dev)
        for b in self.buckets:
            ok = b.cols < self.shape[1]  # the binary sentinel adds nothing
            r = b.row_ids.long()[:, None].expand_as(b.cols)
            out.index_put_((r[ok], b.cols.long()[ok]), b.vals[ok],
                           accumulate=True)
        return out


@dataclasses.dataclass(frozen=True)
class SegmentedEll:
    """Column-segmented ELL: one EllMatrix per column range. Row ids are
    global; column ids are segment-local."""

    segments: Tuple[EllMatrix, ...]
    col_offsets: tuple  # start column of each segment
    seg_cols: int  # columns per segment (the last may be short)
    shape: tuple
    nnz: int
    plan: Any = None
    tables: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False)

    @property
    def dtype(self):
        return self.segments[0].dtype if self.segments else torch.float32

    @property
    def device(self):
        for s in self.segments:
            if s.device is not None:
                return s.device
        return None

    @property
    def padded_nnz(self) -> int:
        return sum(s.padded_nnz for s in self.segments)

    def todense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=torch.float32,
                          device=self.device or "cpu")
        for off, seg in zip(self.col_offsets, self.segments):
            out[:, off : off + seg.shape[1]] += seg.todense().to(out.device)
        return out


def build_ell(mat, config: Config = DEFAULT, dtype=None, split_rows: int = 0,
              device="cuda") -> EllMatrix:
    """Compile a COO/CSR matrix into :class:`EllMatrix` on ``device``.

    ``split_rows > 0`` splits rows longer than that many nonzeros into
    several bucket rows sharing the original row id (f32 gather-engine
    layouts only), so every width stays within the whole-row bodies.
    ``dtype``: a torch dtype for the values (binary input: f32 default).
    """
    csr = mat if isinstance(mat, (CSR, BinaryCSR)) else to_csr_host(mat)
    nrow, ncol = csr.shape
    is_binary = isinstance(csr, BinaryCSR)
    if is_binary:
        dtype = dtype or torch.float32
        vals_src = csr.valid_mask().to(dtype)
    else:
        vals_src = csr.vals if dtype is None else csr.vals.to(dtype)
        dtype = vals_src.dtype

    row_ptr = csr.row_ptr.cpu().numpy().astype(np.int64)
    counts = np.diff(row_ptr)
    max_count = int(counts.max()) if nrow else 0
    split = int(split_rows) if split_rows and max_count > split_rows else 0

    # virtual rows: row r becomes ceil(count/split) sub-rows of <= split
    # slots each (split=0: one virtual row per row)
    if split:
        nsub = np.maximum(-(-counts // split), 1)
    else:
        nsub = np.ones(nrow, np.int64)
    vbase = np.zeros(nrow + 1, np.int64)
    np.cumsum(nsub, out=vbase[1:])
    nv = int(vbase[-1])
    vrow = np.repeat(np.arange(nrow, dtype=np.int64), nsub)
    subi = np.arange(nv, dtype=np.int64) - vbase[vrow]
    vcount = counts[vrow] - subi * split
    if split:
        vcount = np.minimum(vcount, split)
    vcount = np.maximum(vcount, 0)  # empty rows are stored nowhere

    widths_allowed = sorted(set(config.ell_bucket_widths))
    if split:
        widths_allowed = [w for w in widths_allowed if w <= split]
        if not widths_allowed or widths_allowed[-1] != split:
            widths_allowed.append(split)
    # packable (binary, 16-bit columns) builds keep only even widths, so
    # every bucket takes the packed-pair bodies and the sweeps
    rows_pad_x = -(-max(ncol + 1, 8) // 8) * 8  # the unit X panel height
    if is_binary and rows_pad_x <= 65536:
        widths_allowed = sorted({w + (w & 1) for w in widths_allowed})
    max_needed = int(vcount.max()) if nv else 1
    if max_needed > widths_allowed[-1]:
        widths_allowed.append(_ceil_pow2(max_needed))

    # each virtual row takes the smallest width that fits
    width_of_vrow = np.empty(nv, np.int64)
    for w in reversed(widths_allowed):
        width_of_vrow[vcount <= w] = w
    width_of_vrow[vcount == 0] = 0

    buckets_meta = []  # (width, vrows_in_bucket, nb_padded, flat_base)
    flat_base = 0
    loc_of_vrow = np.zeros(nv, np.int64)  # slot within its bucket
    base_of_vrow = np.zeros(nv, np.int64)  # flat offset of its bucket
    widthk_of_vrow = np.zeros(nv, np.int64)
    for w in widths_allowed:
        vrows_b = np.nonzero(width_of_vrow == w)[0]
        if vrows_b.size == 0:
            continue
        nb = _round_up8(max(vrows_b.size, 8))  # the 8-row group, not pow2
        buckets_meta.append((w, vrows_b, nb, flat_base))
        loc_of_vrow[vrows_b] = np.arange(vrows_b.size)
        base_of_vrow[vrows_b] = flat_base
        widthk_of_vrow[vrows_b] = w
        flat_base += nb * w
    flat_size = max(flat_base + 1, 1)  # +1: dump slot for invalid entries

    # slot of every entry (row-sorted CSR: offset within its row)
    n = csr.n_valid
    rows_np = csr.rows[:n].cpu().numpy().astype(np.int64)
    slot_k = np.arange(n, dtype=np.int64) - row_ptr[rows_np]
    if split:
        vr = np.clip(vbase[rows_np] + slot_k // split, 0, nv - 1)
        within = slot_k - (vr - vbase[rows_np]) * split
    else:
        vr = vbase[rows_np]
        within = slot_k
    slot = base_of_vrow[vr] + loc_of_vrow[vr] * widthk_of_vrow[vr] + within

    # one device fill of every entry into the concatenated buckets; binary
    # matrices pad columns with the sentinel ``ncol``
    pad_col = ncol if is_binary else 0
    slot_d = torch.as_tensor(slot, device=device)
    flat_cols = torch.full((flat_size,), pad_col, dtype=torch.int32,
                           device=device)
    flat_vals = torch.zeros((flat_size,), dtype=dtype, device=device)
    flat_cols[slot_d] = csr.cols[:n].to(device=device, dtype=torch.int32)
    flat_vals[slot_d] = vals_src[:n].to(device)

    from ..ops.kernels.ell_spmm import _pack_pairs, packed_pair_ok

    buckets = []
    padded = 0
    for w, vrows_b, nb, base in buckets_meta:
        row_ids = np.zeros(nb, np.int32)
        row_ids[: vrows_b.size] = vrow[vrows_b]  # original row ids
        cols_b = flat_cols[base : base + nb * w].reshape(nb, w)
        vals_b = flat_vals[base : base + nb * w].reshape(nb, w)
        packed_b = (
            _pack_pairs(cols_b).reshape(nb, w // 2)
            if is_binary and packed_pair_ok(w, rows_pad_x)
            else None
        )
        buckets.append(EllBucket(
            row_ids=torch.as_tensor(row_ids, device=device), cols=cols_b,
            vals=vals_b, width=w, n_real=int(vrows_b.size), packed=packed_b,
        ))
        padded += nb * w
    return EllMatrix(buckets=tuple(buckets), shape=(nrow, ncol),
                     nnz=csr.n_valid, padded_nnz=padded, unit_vals=is_binary,
                     split_rows=split)


def build_ell_segmented(mat, config: Config = DEFAULT, seg_cols: int = 16384,
                        dtype=None, split_rows: int = 0,
                        device="cuda") -> SegmentedEll:
    """Compile into column-segmented bucketed ELL on ``device``: one
    `build_ell` per ``seg_cols``-wide column range, columns segment-local.
    """
    if isinstance(mat, (CSR, BinaryCSR)):
        mat = mat.to_coo()
    nrow, ncol = mat.shape
    is_binary = isinstance(mat, BinaryCOO)
    n = mat.n_valid
    rows = mat.rows[:n].cpu().numpy()
    cols = mat.cols[:n].cpu().numpy()
    vals = None if is_binary else mat.vals[:n].cpu()
    nseg = max(-(-ncol // seg_cols), 1)
    segments, offsets = [], []
    for si in range(nseg):
        lo = si * seg_cols
        hi = min(lo + seg_cols, ncol)
        sel = (cols >= lo) & (cols < hi)
        if is_binary:
            seg_coo = BinaryCOO.from_arrays(rows[sel], cols[sel] - lo,
                                            (nrow, hi - lo), device="cpu")
        else:
            seg_coo = COO(
                rows=torch.as_tensor(rows[sel].astype(np.int32)),
                cols=torch.as_tensor((cols[sel] - lo).astype(np.int32)),
                vals=vals[torch.as_tensor(sel)], shape=(nrow, hi - lo),
                n_valid=int(sel.sum()),
            )
        # binary segments keep unit f32 values whatever ``dtype`` says, as
        # in the reference
        segments.append(build_ell(seg_coo, config=config,
                                  dtype=None if is_binary else dtype,
                                  split_rows=split_rows, device=device))
        offsets.append(lo)
    return SegmentedEll(segments=tuple(segments), col_offsets=tuple(offsets),
                        seg_cols=seg_cols, shape=(nrow, ncol), nnz=int(n))


@dataclasses.dataclass(frozen=True)
class DdEll:
    """Double-word valued ELL: two structure-equal builds (EllMatrix or
    SegmentedEll) whose f32 value planes satisfy ``hi + lo == v`` (f64) to
    ~2^-48. The planes share their ``row_ids`` and ``cols`` tensors."""

    hi: Any  # EllMatrix | SegmentedEll, f32 head plane
    lo: Any  # same structure, f32 residual plane
    shape: tuple
    nnz: int

    @property
    def device(self):
        return self.hi.device


def _with_vals(A, f):
    """``A`` (EllMatrix or SegmentedEll) with every bucket's values
    replaced by ``f(vals)``; structure tensors are shared."""
    if isinstance(A, SegmentedEll):
        return dataclasses.replace(
            A, segments=tuple(_with_vals(s, f) for s in A.segments))
    return dataclasses.replace(A, buckets=tuple(
        dataclasses.replace(b, vals=f(b.vals)) for b in A.buckets))


def build_ell_dd(mat, config: Config = DEFAULT, seg_cols=None,
                 device="cuda") -> DdEll:
    """Compile a valued matrix (a scipy matrix or a port COO/CSR; f64
    values) into :class:`DdEll` on ``device``, as the reference builds it.

    ``seg_cols=None`` segments at 8,192 columns when the matrix is wider
    (the reference's TPU residency choice, kept as a layout parameter);
    ``0`` never segments. The entries are placed by position only, so the
    port builds the structure once with f64 values and splits each slot's
    value: ``vh = f32(v)``, ``vl = f32(v - vh)``, the reference's host
    split, which gives the reference's ``hi`` and ``lo`` layouts."""
    if isinstance(mat, BinaryCOO):
        raise TypeError("binary matrices use the unit dd path (build_ell)")
    if hasattr(mat, "tocoo"):  # scipy
        m = mat.tocoo()
        rows, cols = m.row.astype(np.int64), m.col.astype(np.int64)
        vals, shape = m.data.astype(np.float64), tuple(m.shape)
    else:
        if isinstance(mat, (CSR, BinaryCSR)):
            mat = mat.to_coo()
        n = mat.n_valid
        rows = mat.rows[:n].cpu().numpy().astype(np.int64)
        cols = mat.cols[:n].cpu().numpy().astype(np.int64)
        vals = mat.vals[:n].cpu().numpy().astype(np.float64)
        shape = tuple(mat.shape)
    if seg_cols is None:
        seg_cols = 8192 if shape[1] > 8192 else 0
    coo = COO(rows=torch.as_tensor(rows.astype(np.int32)),
              cols=torch.as_tensor(cols.astype(np.int32)),
              vals=torch.as_tensor(vals), shape=shape, n_valid=int(rows.size))
    if seg_cols:
        A = build_ell_segmented(coo, config=config, seg_cols=seg_cols,
                                device=device)
    else:
        A = build_ell(coo, config=config, device=device)
    return DdEll(
        hi=_with_vals(A, lambda v: v.float()),
        lo=_with_vals(A, lambda v: (v - v.float().double()).float()),
        shape=shape, nnz=int(rows.size),
    )
