"""The four f32 ELL gather kernels: CUDA wrappers and their plain PyTorch
twins.

Counterpart of ``fastsparse/ops/pallas/ell_spmm.py`` (f32 path). On a CUDA
tensor each public function launches the hand-written sm_90a kernel from
``csrc/ell_spmm.cu`` (built at first use, `_build.load_library`) and adds
one to its entry in `launches`; a build or launch failure raises. On a CPU
tensor it runs the ``*_plain`` version: the same gathers and the same
accumulation order in eager torch ops, which is also the on-card oracle.

The body a bucket takes is the reference's choice (`_body_mode`): whole-row
unroll for ``K <= _FULL_K_MAX`` (over packed column pairs for unit buckets
that pass `packed_pair_ok`), else chunks of ``_pick_kb(K)`` entries (of
``2·KB2`` entries over packed pairs). The constants are the reference's
layout parameters, kept for parity; they are not limits of this card.
`ell_bucket_spmm_smem` (one launch per whole bucket) always runs the
chunked order over plain columns, at every width.

`ell_table_spmm` runs every part of a narrow product (X of at most
``TABLE_MAX_LANES`` lanes) in one launch, over a device table of work tiles
that `ell_table` builds from the parts (`EllPart`, one per bucket chunk or
sweep sub-part, in the layout's order): each part keeps its body, so each
row is the per-part kernels' sum, bit for bit. It replaces no Pallas kernel
of its own: the reference launches one kernel per part. It has an f64 mode
(a table built with ``dtype=torch.float64``): f64 values, X, products and
sums in the same order, for float64 products, which the TPU reference
computes in double-word f32 arithmetic (`ops.kernels.ell_dd`) and this
card computes natively.

Interface differences from the reference kernels: no ``n_block``. The CUDA
kernel covers all of X's lanes in one launch, so ``x`` may have any lane
count and the output has the same; the reference's 128-lane blocks are a
TPU tiling.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple

import numpy as np
import torch

from ... import tracing
from .bsr_spmm import _check, _launch, _library_for, _ptr

__all__ = [
    "launches",
    "reset_launches",
    "ELL_GROUP",
    "SMEM_BLOCK_K_UNIT",
    "SMEM_BLOCK_K_VALUED",
    "packed_pair_ok",
    "ell_bucket_spmm",
    "ell_bucket_spmm_plain",
    "ell_sweep_spmm",
    "ell_sweep_spmm_plain",
    "ell_bucket_spmm_smem",
    "ell_bucket_spmm_smem_plain",
    "TABLE_MAX_LANES",
    "EllPart",
    "EllTable",
    "ell_table",
    "ell_table_spmm",
    "ell_table_spmm_plain",
]

ELL_GROUP = 8  # bucket rows per TPU grid step; bucket heights are multiples
_N_ACC = 4  # accumulators per row; entry u of a chunk goes to u % 4
_KB_MAX = 16  # entries per chunk of the chunked bodies
_FULL_K_MAX = 64  # widths up to this run the whole-row body
_PACKED_KB_MAX = 32  # packed pairs per chunk of the chunked packed body
# widest buckets the reference's SMEM-blocked kernel takes (a layout
# parameter of `ops.ell_ops._seg_layout`; `ell_bucket_spmm_smem` itself
# takes any width)
SMEM_BLOCK_K_UNIT = 8192
SMEM_BLOCK_K_VALUED = 4096
_SWEEP_MAX_PARTS = 128  # SWEEP_MAX_PARTS in csrc/ell_spmm.cu
TABLE_MAX_LANES = 8  # NARROW_MAX_LANES in csrc/ell_spmm.cu
# slots a staged tile of `ell_table` holds at one X lane (its products take
# table_stride(K)/K times as many words, at most 1.5x: under 30 KB of
# shared memory a block at f32, so four blocks share an SM; tiles of 1,024,
# 3,072 and 4,096 slots ran the 250,000-square SpMV slower on an H100). At
# f64 a slot's value and product take twice the bytes (under 48 KB a block)
# and the f64 kernel three blocks an SM, and 2,048 slots is still the
# fastest: 1,024- and 4,096-slot tiles ran the 100,000-square f64 SpMV 3 %
# and 13 % slower on an H100
_TABLE_SLOTS = 2048
_TABLE_GLOBAL_ROWS = 32  # rows a tile of rows wider than the stage walks
# EllTile.flags in csrc/ell_spmm.cu
_TILE_FULL, _TILE_PACKED, _TILE_STAGED = 1, 2, 4

# kernel launches per wrapper (CUDA path only; the plain versions never count)
launches = {"ell_bucket": 0, "ell_sweep": 0, "ell_bucket_smem": 0,
            "ell_table": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def packed_pair_ok(K: int, nx_rows: int) -> bool:
    """True when a unit bucket of width K against an X panel of ``nx_rows``
    rows (sentinel included) may use packed 16-bit column pairs."""
    return K % 2 == 0 and nx_rows <= 65536


def _pick_kb(K: int) -> int:
    """Entries per chunk: the largest divisor of K that is <= _KB_MAX (KB
    must divide K, or a row's tail entries would be dropped)."""
    for kb in range(min(_KB_MAX, K), 0, -1):
        if K % kb == 0:
            return kb
    return 1


# device ops `_pack_pairs` enqueues
_PACK_OPS = 8


def _pack_pairs(cols):
    """int32[nb, K even] -> packed int32[nb·K/2] (c0 | c1<<16)."""
    c0 = cols[:, 0::2].long()
    c1 = cols[:, 1::2].long()
    p = c0 | (c1 << 16)
    return torch.where(p >= 2**31, p - 2**32, p).to(torch.int32).reshape(-1)


def _unpack_pairs(words):
    """packed int32[n, K2] -> int32[n, 2·K2] columns (c0, c1 interleaved)."""
    c0 = words & 0xFFFF
    c1 = (words >> 16) & 0xFFFF  # logical shift of the 32-bit word
    return torch.stack([c0, c1], dim=2).reshape(words.shape[0], -1)


def _body_mode(K: int, nx_rows: int, unit: bool):
    """(KB, full, packed): entries per chunk, whole-row body or not, and
    whether the body reads packed pairs, as the reference picks them."""
    if K <= _FULL_K_MAX:
        return K, True, unit and packed_pair_ok(K, nx_rows)
    if unit and packed_pair_ok(K, nx_rows):
        K2 = K // 2
        kb2 = next(kb for kb in range(min(_PACKED_KB_MAX, K2), 0, -1)
                   if K2 % kb == 0)
        return 2 * kb2, False, True
    return _pick_kb(K), False, False


def _gather_rows(cols, vals, x, KB: int, full: bool):
    """``Σ_k vals[r, k]·x[cols[r, k]]`` per row (unit when ``vals`` is
    None) in the kernels' order: chunks of KB entries, entry u of a chunk
    into accumulator u % 4, ``((a0 + a1) + a2) + a3``, the chunk sums
    added into a zeroed output (stored directly when ``full``)."""
    nb, K = cols.shape
    idx = cols.long()
    out = torch.zeros((nb, x.shape[1]), dtype=x.dtype, device=x.device)
    for t0 in range(0, K, KB):
        acc = [torch.zeros_like(out) for _ in range(_N_ACC)]
        for u in range(KB):
            d = x[idx[:, t0 + u]]
            if vals is not None:
                d = d * vals[:, t0 + u, None]
            acc[u % _N_ACC] = acc[u % _N_ACC] + d
        s = ((acc[0] + acc[1]) + acc[2]) + acc[3]
        out = s if full else out + s
    return out


def _bucket_words(cols, packed):
    nb, K = cols.shape
    words = packed if packed is not None else _pack_pairs(cols)
    return words.reshape(nb, K // 2)


def ell_bucket_spmm_plain(cols, vals, x, *, unit: bool = False, packed=None):
    nb, K = cols.shape
    KB, full, use_packed = _body_mode(K, x.shape[0], unit)
    if use_packed:
        cols = _unpack_pairs(_bucket_words(cols, packed))
    return _gather_rows(cols, None if unit else vals, x, KB, full)


def ell_bucket_spmm(cols, vals, x, *, unit: bool = False, packed=None):
    """One ELL bucket's ``Y_b = A_b @ X``: f32 ``(nb, x.shape[1])``.

    Replaces ``ell_spmm.py:ell_bucket_spmm`` (all five bodies). ``cols``
    int32 ``(nb, K)``; ``vals`` f32 ``(nb, K)`` (ignored when ``unit``);
    ``x`` f32 ``(nx_rows, N)``. In unit mode padding columns must point at
    a zero row of ``x`` (the builder's sentinel). ``packed``: the bucket's
    build-time pairs int32 ``(nb, K/2)``; without it the packed bodies pack
    ``cols`` per call."""
    dev = x.device
    _check("ell_bucket.cols", cols, torch.int32, 2, dev)
    _check("ell_bucket.x", x, torch.float32, 2)
    nb, K = cols.shape
    if nb % ELL_GROUP:
        raise ValueError(f"ell_bucket: nb={nb} not a multiple of {ELL_GROUP}")
    if not unit:
        _check("ell_bucket.vals", vals, torch.float32, 2, dev)
        if tuple(vals.shape) != (nb, K):
            raise ValueError("ell_bucket: vals and cols disagree")
    KB, full, use_packed = _body_mode(K, x.shape[0], unit)
    if use_packed and packed is not None:
        _check("ell_bucket.packed", packed, torch.int32, packed.ndim, dev)
        if packed.numel() != nb * K // 2:
            raise ValueError("ell_bucket: packed pairs disagree with cols")
    lib = _library_for(x)
    if lib is None:
        return ell_bucket_spmm_plain(cols, vals, x, unit=unit, packed=packed)
    if use_packed and packed is None:
        tracing.count(_PACK_OPS)
    idx = _bucket_words(cols, packed).contiguous() if use_packed else cols
    out = torch.empty((nb, x.shape[1]), dtype=torch.float32, device=dev)
    _launch(
        "ell_bucket", lib.fs_ell_bucket, _ptr(idx),
        None if unit else _ptr(vals), _ptr(x), _ptr(out), nb, K, KB,
        int(full), int(unit), int(use_packed), x.shape[1], counts=launches,
    )
    return out


@functools.lru_cache(maxsize=256)
def _sweep_table(parts):
    """Host part table of a sweep: row0 (n+1), K2 and first word per part,
    int32 (the kernel's grid constant)."""
    row0, k2, wbase = [0], [], []
    w = 0
    for n_rows, K2 in parts:
        if n_rows % ELL_GROUP:
            raise ValueError(f"ell_sweep: part of {n_rows} rows is not a "
                             f"multiple of {ELL_GROUP}")
        row0.append(row0[-1] + n_rows)
        k2.append(K2)
        wbase.append(w)
        w += n_rows * K2
    if w >= 2**31 or row0[-1] >= 2**31:
        raise ValueError("ell_sweep: part table past int32")
    return (np.asarray(row0, np.int32), np.asarray(k2, np.int32),
            np.asarray(wbase, np.int32), w)


def ell_sweep_spmm_plain(flat_words, x, *, parts):
    row0, k2, wbase, _ = _sweep_table(tuple(parts))
    outs = []
    for p, (n_rows, K2) in enumerate(parts):
        w0 = int(wbase[p])
        words = flat_words[w0 : w0 + n_rows * K2].reshape(n_rows, K2)
        outs.append(_gather_rows(_unpack_pairs(words), None, x, 2 * K2, True))
    if not outs:
        return torch.zeros((0, x.shape[1]), dtype=torch.float32, device=x.device)
    return torch.cat(outs)


def ell_sweep_spmm(flat_words, x, *, parts):
    """Unit-mode multi-bucket sweep: f32 ``(Σ n_rows, x.shape[1])``.

    Replaces ``ell_spmm.py:ell_sweep_spmm``. ``parts`` is a tuple of
    ``(n_rows, K2)`` per sub-part (each ``n_rows`` a multiple of
    ELL_GROUP); ``flat_words`` int32 concatenates each sub-part's packed
    pairs row-major. Every part runs the whole-row packed body; output rows
    come in sub-part order, the order `ops.assemble` consumes."""
    parts = tuple((int(n), int(k)) for n, k in parts)
    _check("ell_sweep.words", flat_words, torch.int32, 1, x.device)
    _check("ell_sweep.x", x, torch.float32, 2)
    row0, k2, wbase, n_words = _sweep_table(parts)
    if flat_words.numel() != n_words:
        raise ValueError(f"ell_sweep: {flat_words.numel()} words, the parts "
                         f"need {n_words}")
    if x.shape[0] > 65536:
        raise ValueError("ell_sweep: packed pairs address at most 65536 X rows")
    lib = _library_for(x)
    if lib is None:
        return ell_sweep_spmm_plain(flat_words, x, parts=parts)
    if not 0 < len(parts) <= _SWEEP_MAX_PARTS:
        raise NotImplementedError(
            f"ell_sweep CUDA kernel takes 1..{_SWEEP_MAX_PARTS} parts, "
            f"got {len(parts)}"
        )
    out = torch.empty((int(row0[-1]), x.shape[1]), dtype=torch.float32,
                      device=x.device)
    _launch(
        "ell_sweep", lib.fs_ell_sweep, _ptr(flat_words), _ptr(x), _ptr(out),
        row0.ctypes.data, k2.ctypes.data, wbase.ctypes.data, len(parts),
        x.shape[1], counts=launches,
    )
    return out


def ell_bucket_spmm_smem_plain(cols, vals, x, *, unit: bool = False):
    K = cols.shape[1]
    return _gather_rows(cols, None if unit else vals, x, _pick_kb(K), False)


def ell_bucket_spmm_smem(cols, vals, x, *, unit: bool = False):
    """One whole ELL bucket's ``Y_b = A_b @ X`` in one launch: f32 ``(nb,
    x.shape[1])``.

    Replaces ``ell_spmm.py:ell_bucket_spmm_smem``. ``cols`` int32 ``(nb,
    K)`` (plain columns, also in unit mode; padding columns of a unit
    bucket point at a zero row of ``x``); ``vals`` f32 ``(nb, K)``
    (ignored when ``unit``); ``x`` f32 ``(nx_rows, N)``. The summation is
    the reference's ``_body_smem``: chunks of ``_pick_kb(K)`` entries,
    entry u into accumulator u % 4, each chunk's sum added in order into a
    zeroed row. For ``K <= 64`` that is not `ell_bucket_spmm`'s whole-row
    order, so the two differ in their last bits there."""
    dev = x.device
    _check("ell_bucket_smem.cols", cols, torch.int32, 2, dev)
    _check("ell_bucket_smem.x", x, torch.float32, 2)
    nb, K = cols.shape
    if nb % ELL_GROUP:
        raise ValueError(f"ell_bucket_smem: nb={nb} not a multiple of "
                         f"{ELL_GROUP}")
    if not unit:
        _check("ell_bucket_smem.vals", vals, torch.float32, 2, dev)
        if tuple(vals.shape) != (nb, K):
            raise ValueError("ell_bucket_smem: vals and cols disagree")
    lib = _library_for(x)
    if lib is None:
        return ell_bucket_spmm_smem_plain(cols, vals, x, unit=unit)
    out = torch.empty((nb, x.shape[1]), dtype=torch.float32, device=dev)
    _launch(
        "ell_bucket_smem", lib.fs_ell_smem, _ptr(cols),
        None if unit else _ptr(vals), _ptr(x), _ptr(out), nb, K, _pick_kb(K),
        int(unit), x.shape[1], counts=launches,
    )
    return out


# --------------------------------------------------- one launch, every part
class EllPart(NamedTuple):
    """One part of a narrow product: rows ``[row0, row0 + n_src)`` of a
    bucket, padded to ``n_rows`` output rows (+0), summed by the body
    ``(KB, full)`` against the X panel at row ``x_row0``. ``idx``: the
    bucket's columns int32 ``(nb, K)`` or, when ``packed``, its pairs
    ``(nb, K/2)``; ``vals``: its values ``(nb, K)``, None in unit mode."""

    idx: torch.Tensor
    vals: Any
    row0: int
    n_src: int
    n_rows: int
    K: int
    KB: int
    full: bool
    packed: bool
    x_row0: int


@dataclasses.dataclass(frozen=True)
class EllTable:
    """The work tiles of one narrow product (`ell_table`). ``tiles``: host
    int64 ``(n_tiles, 6)``, the kernel's ``EllTile`` records (on a CPU
    layout the two pointer columns hold byte offsets into each part's
    ``idx`` and ``vals`` storage); ``dev``: ``tiles`` on the card, None on
    the CPU. A tile is a run of rows of one part whose slots fit
    ``_TABLE_SLOTS // lanes`` (staged in shared memory), else of
    ``_TABLE_GLOBAL_ROWS`` rows walked in global memory. ``*_cap``: the
    shared-memory elements the largest staged tile needs (spans rounded
    out to 16 bytes, and its products): index words, and values and
    products of ``dtype``, the product's (f32 or f64)."""

    parts: tuple
    tiles: np.ndarray
    dev: Any
    n_slots: int
    x_rows: int
    lanes: int
    unit: bool
    idx_cap: int
    val_cap: int
    prod_cap: int
    dtype: Any


def _table_stride(K: int) -> int:
    """table_stride in csrc/ell_spmm.cu: words between staged rows'
    products."""
    return K | 1 if K <= 8 else K + (12 - K % 8) % 8


def _words4(n: int) -> int:
    return -(-n // 4) * 4


def ell_table(parts, lanes: int, unit: bool, x_rows: int, device,
              dtype=torch.float32):
    """The tile table of a narrow product over ``parts`` (`EllPart`, in
    output order): output rows are the parts' rows in turn, the slot stream
    the per-part kernels' outputs concatenate to. Each part is cut into
    tiles of about equal slot counts, in part order. ``dtype``: the
    product's, f32 or f64 (valued parts hold values of it). On a CUDA
    ``device`` the records go to the card in one copy."""
    if not 0 < lanes <= TABLE_MAX_LANES:
        raise ValueError(f"ell_table: {lanes} lanes, at most "
                         f"{TABLE_MAX_LANES}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ell_table: {dtype} products (f32 or f64 only)")
    cuda = torch.device(device).type == "cuda"
    esize = 8 if dtype == torch.float64 else 4
    stage = _TABLE_SLOTS // lanes
    recs = []
    idx_cap = val_cap = prod_cap = 0
    out_row = 0
    for pt in parts:
        kw = pt.K // 2 if pt.packed else pt.K
        if pt.packed and not unit:
            raise ValueError("ell_table: packed pairs are unit-only")
        if pt.idx.is_cuda != cuda or not pt.idx.is_contiguous() or (
                not unit and not pt.vals.is_contiguous()):
            raise ValueError("ell_table: parts must be contiguous on the "
                             "table's device")
        if not unit and pt.vals.dtype != dtype:
            raise TypeError(f"ell_table: {pt.vals.dtype} values in a "
                            f"{dtype} table")
        staged = pt.K <= stage
        if staged:
            n_t = -(-pt.n_rows // max(1, stage // pt.K))
            rows = -(-pt.n_rows // max(n_t, 1))
        else:
            rows = _TABLE_GLOBAL_ROWS
        i0 = pt.idx.data_ptr() if cuda else 0
        v0 = pt.vals.data_ptr() if cuda and not unit else 0
        flags = ((_TILE_FULL if pt.full else 0)
                 | (_TILE_PACKED if pt.packed else 0)
                 | (_TILE_STAGED if staged else 0))
        for r0 in range(0, pt.n_rows, rows):
            n = min(rows, pt.n_rows - r0)
            src = min(max(pt.n_src - r0, 0), n)
            r = pt.row0 + r0
            recs.append((i0 + r * kw * 4,
                         0 if unit else v0 + r * pt.K * esize,
                         (out_row + r0) | (pt.x_row0 << 32), n | (src << 32),
                         pt.K | (pt.KB << 32), flags))
            if staged:
                idx_cap = max(idx_cap, _words4(3 + n * kw))
                if not unit:  # a span starts up to 16 bytes early
                    val_cap = max(val_cap,
                                  _words4(16 // esize - 1 + n * pt.K))
                prod_cap = max(prod_cap,
                               _words4(n * _table_stride(pt.K) * lanes))
        out_row += pt.n_rows
    if out_row >= 2**31 or x_rows >= 2**31:
        raise ValueError("ell_table: rows past int32")
    tiles = np.asarray(recs, np.int64).reshape(-1, 6)
    dev = None
    if cuda:
        dev = torch.from_numpy(tiles).to(device)
        tracing.count()
    return EllTable(parts=tuple(parts), tiles=tiles, dev=dev,
                    n_slots=out_row, x_rows=int(x_rows), lanes=int(lanes),
                    unit=bool(unit), idx_cap=idx_cap, val_cap=val_cap,
                    prod_cap=prod_cap, dtype=dtype)


def ell_table_spmm_plain(table, x):
    """Part by part in output order: each part's rows by its own body
    (`_gather_rows`, as `ell_bucket_spmm_plain` and `ell_sweep_spmm_plain`
    compute them), padding rows +0, in the table's dtype."""
    out = torch.zeros((table.n_slots, x.shape[1]), dtype=table.dtype,
                      device=x.device)
    row = 0
    for pt in table.parts:
        if pt.n_src:
            idx = pt.idx[pt.row0 : pt.row0 + pt.n_src]
            cols = _unpack_pairs(idx) if pt.packed else idx
            vals = (None if table.unit
                    else pt.vals[pt.row0 : pt.row0 + pt.n_src])
            out[row : row + pt.n_src] = _gather_rows(
                cols, vals, x[pt.x_row0 :], pt.KB, pt.full)
        row += pt.n_rows
    return out


def ell_table_spmm(table, x):
    """Every part of a narrow product in one launch: ``(n_slots, lanes)``
    of the table's dtype, each part's rows at its place in the slot
    stream, bit-equal to the per-part kernels' outputs concatenated
    (padding rows +0, where a part's padding reads a zero row or a zero
    value); at f64, to its plain twin's f64 arithmetic in the same order.

    ``table``: `ell_table`'s; ``x`` ``(table.x_rows, table.lanes)`` of its
    dtype, every part's X panel at its ``x_row0`` (unit padding columns at
    a zero row of it). On the card `fs_ell_table`: one block a tile; a
    staged tile's index and value spans arrive by one bulk copy each,
    every slot's product is formed in shared memory, then each row's sum
    in the reference's order."""
    _check("ell_table.x", x, table.dtype, 2)
    if tuple(x.shape) != (table.x_rows, table.lanes):
        raise ValueError(f"ell_table: x {tuple(x.shape)}, the table needs "
                         f"{(table.x_rows, table.lanes)}")
    lib = _library_for(x)
    if lib is None:
        return ell_table_spmm_plain(table, x)
    if table.dev is None or table.dev.device != x.device:
        raise ValueError("ell_table: the table was built for another device")
    out = torch.empty((table.n_slots, table.lanes), dtype=table.dtype,
                      device=x.device)
    _launch(
        "ell_table", lib.fs_ell_table, _ptr(table.dev), len(table.tiles),
        _ptr(x), _ptr(out), table.lanes, int(table.unit),
        int(table.dtype == torch.float64), table.idx_cap, table.val_cap,
        table.prod_cap, counts=launches,
    )
    return out
