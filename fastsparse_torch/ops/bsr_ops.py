"""BSR products: X encoding, kernel dispatch, part assembly and the
normal-equation chain (counterpart of ``fastsparse/ops/bsr_ops.py``).

Mono layouts: every product of an int8-panel mono layout with an f32
operand runs at fp32 parity through radix-256 int8 X planes: per RHS
column j, ``x ≈ (q0·2^16 + q1·2^8 + q2)·s_j`` with
``s_j = colmax_j/(127·2^16)``, so each plane is one exact s8·s8→s32 dot.
Wide products (N > 40) encode X with the `colmax` and `quant3_planes`
kernels and run `mono_panel_spmm` in fold "i8w"; narrow products (N <= 40)
encode with `quant3_encode` (the reference does this in XLA; on the card
two launches over X in place) and fold the three plane blocks after the
kernel. The mono kernels take their planes K-major
(``(lanes, K)``, the transpose of the reference's ``(K, lanes)``: the s8
tensor cores read B only so). N <= 8 goes to the halo engine
(`mono_group_spmm`) when the matrix has one.

Tile-bucket and class-panel layouts (and `ColSegmented` containers of
them): fp32 parity from three bf16 planes of X over tiles that are exact
in bf16 (0/1 values as bf16 or int8). Tile buckets run `bucket_spmm`
(planes stacked along the lanes for N > 40, the narrow packing
``[x0|x1|x2]`` in one 128-lane block for N <= 40, or plain f32 tiles × f32
X for valued matrices); class panels run `panel_spmm` (the planes split
in-kernel from f32 X for N > 40, the narrow packing for N <= 40); SpMV on
tile buckets runs `bucket_spmv`. Each bucket is cut into parts of at most
``_SMEM_IDX_BUDGET`` index entries, and the parts' strip panels are
assembled by the layout's gather plan (`ops.assemble`). The reference's
TPU residency budgets (``_SMEM_IDX_BUDGET``, ``RESIDENT_VMEM_BUDGET``, the
``n_block`` cap, `pick_strategy`) are kept as layout parameters for
parity: they decide the part count, the plans and the arithmetic.

The kernels take the f32 operand at ``precision="highest"``. An operand
dtype the reference has no kernel for (`pallas_supported` false: f64)
runs, as in the reference, through the COO scatter engine over the
layout's entries (`_as_coo`, bucket by bucket, never densified). bf16
operands and other precisions raise `NotImplementedError`, as do the
bodies off this path (the streamed tile body and the bitmask modes, slice
3b; the reference's pre-split panel fold, off by its default, is not
ported).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import tracing
from ..formats.bsr import BsrMatrix, MonoPanelBucket, PanelBucket
from .kernels.bsr_spmm import (
    S_UNIT as _S_UNIT,
    colmax,
    mono_group_spmm,
    mono_panel_spmm,
    quant3_encode,
    quant3_planes,
)
from .kernels.bsr_tiles import bucket_spmm, bucket_spmv, panel_spmm

__all__ = ["bsr_spmm", "bsr_spmv", "colseg_spmm", "halo_nq", "mono_chain",
           "pallas_supported"]

LANES = 128
# Layout parameters of the reference's TPU budgets, kept for parity: index
# entries per part (its SMEM budget) and the X-panel residency budget that
# caps n_block and picks the tile body.
_SMEM_IDX_BUDGET = 64 * 1024
RESIDENT_VMEM_BUDGET = 12 * 1024 * 1024
# Widest narrow padded width the halo engine serves (the reference adopted
# it for N <= 8 only; N in 9..40 takes the per-item narrow path).
HALO_NQ_MAX = 8


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pallas_supported(dtype) -> bool:
    """The reference's gate: operand dtypes its tile kernels take (f32, and
    bf16, whose products are slice 3b). Others run the COO engine."""
    return dtype in (torch.float32, torch.bfloat16)


def _as_coo(A: BsrMatrix, device=None):
    """The layout's entries as a COO on its device, bucket by bucket, in
    the reference's order (``bsr_ops._as_coo``): padding items and entries
    past the matrix dropped, values in the layout's dtype."""
    from ..formats.bsr import BsrBucket
    from ..formats.coo import COO

    if A.binary:
        raise NotImplementedError("bitmask tiles and panels are slice 3b")
    TM, TK, nsp = A.tile_m, A.tile_k, A.n_strips
    rows_l, cols_l, vals_l = [], [], []
    for b in A.buckets:
        sids = b.strip_ids.long()
        if isinstance(b, BsrBucket):
            i, t, r, c = torch.nonzero(b.tiles, as_tuple=True)
            col = b.slab_ids.long()[i, t] * TK + c
            v = b.tiles[i, t, r, c]
        elif isinstance(b, (PanelBucket, MonoPanelBucket)):
            i, r, c = torch.nonzero(b.panels, as_tuple=True)
            starts = (b.start_slab.long() if isinstance(b, PanelBucket)
                      else b.window.long() * b.win_slabs + b.start_rel.long())
            col = starts[i] * TK + c
            v = b.panels[i, r, c]
        else:
            raise NotImplementedError("the grouped mono layout is slice 3b")
        keep = sids[i] < nsp
        rows_l.append((sids[i] * TM + r)[keep])
        cols_l.append(col[keep])
        vals_l.append(v[keep])
    dev = A.device if A.buckets else device
    if rows_l:
        rows, cols, vals = (torch.cat(x) for x in (rows_l, cols_l, vals_l))
    else:
        rows = cols = torch.zeros(0, dtype=torch.int64, device=dev)
        vals = torch.zeros(0, dtype=torch.float32, device=dev)
    keep = (rows < A.shape[0]) & (cols < A.shape[1])
    return COO(rows=rows[keep].to(torch.int32), cols=cols[keep].to(torch.int32),
               vals=vals[keep], shape=tuple(A.shape),
               n_valid=int(keep.sum()))


def _narrow_nq(N: int) -> int:
    """Padded column count of the narrow plane packing, or 0 when N is too
    wide: all three planes of an N-column panel fit 128 lanes when
    3·roundup(N, 8) <= 128."""
    nq = _round_up(max(N, 1), 8)
    return nq if 3 * nq <= LANES else 0


def _require_int8_path(A, x_dtype, precision):
    if precision != "highest":
        raise NotImplementedError(
            f"precision={precision!r}: only 'highest' (fp32 parity) is ported"
        )
    if x_dtype != torch.float32:
        raise NotImplementedError(
            f"X dtype {x_dtype}: only float32 operands are ported (bf16 "
            "products are slice 3b)"
        )
    if A.binary or A.dtype != torch.int8:
        raise NotImplementedError(
            f"mono panels of dtype {A.dtype}: only int8 panels (the "
            "binary_tiles='int8' default for 0/1 matrices) are ported"
        )


def _quant3_planes(Xp, NB: int, Npad: int):
    """f32 (K, Npad) -> (int8 (nj·3·NB, K) K-major planes, f32 (1, Npad)
    scale) through the colmax and quant3 kernels. The scale and its
    reciprocal stay torch ops, as they are XLA ops outside the reference
    kernels."""
    m = colmax(Xp)
    s = torch.where(m > 0, m, 1.0) * _S_UNIT
    # the compare, the `where` and its scalar's fill, the scale, and
    # `1.0 / s`: a reciprocal and a product
    tracing.count(6)
    return quant3_planes(Xp, 1.0 / s, n_block=NB), s


def _pad(X, pads):
    """``F.pad(X, pads)``, counting its device ops: a fill and a copy, or
    one copy when no pad is positive."""
    tracing.count(2 if any(p > 0 for p in pads) else 1)
    return F.pad(X, pads)


def _quant3_narrow(X, K: int, nq: int, nb: int):
    """Narrow int8 planes, K-major (nb, K) as the mono kernels take them:
    q0, q1, q2 of X's first K rows (zero rows past X) in lane rows 0, nq,
    2·nq and zero rows to ``nb`` (the reference's (K, nb) lane layout
    transposed); plus the f32 (1, nq) scale. One `quant3_encode` (on the
    card a fill and two launches over X in place)."""
    return quant3_encode(X.to(torch.float32), k_rows=K, n_pad=nq, n_out=nb)


def _fold_narrow_q(Y, nq: int, scale):
    """Radix-256 recombination of the narrow packing's three plane blocks."""
    tracing.count(5)
    return (
        Y[:, :nq] * 65536.0 + Y[:, nq : 2 * nq] * 256.0 + Y[:, 2 * nq : 3 * nq]
    ) * scale


def _prep_mono_x(A, X, N, precision):
    """Pad and encode X for the mono kernel. Returns ((planes, scale), NB,
    Npad, fold, nq): fold "i8w" for wide N, fold False with ``nq > 0`` for
    the narrow packing; the planes K-major either way. A wide X already
    shaped ``(K_pad, Npad)`` is encoded as it is, with no pad copy (the
    chain relies on this)."""
    b = A.buckets[0]
    TK = A.tile_k
    K_pad = b.n_windows * b.win_slabs * TK
    if X.shape[0] > K_pad:
        X = X[:K_pad]
    _require_int8_path(A, X.dtype, precision)
    nq = _narrow_nq(N)
    if nq:
        nb = _round_up(3 * nq, 32)
        return _quant3_narrow(X, K_pad, nq, nb), nb, nb, False, nq
    NB = LANES
    Npad = _round_up(N, NB)
    if tuple(X.shape) == (K_pad, Npad):
        tracing.count(int(not X.is_contiguous()))
        Xp = X.contiguous()
    else:
        tracing.count(2)
        Xp = X.new_zeros((K_pad, Npad))
        Xp[: X.shape[0], :N] = X
    return _quant3_planes(Xp, NB, Npad), NB, Npad, "i8w", 0


def _mono_raw(A, X, precision):
    """Raw mono product ``(Y, nq, Npad, scale)``: ``Y`` is the kernel's
    full f32 (out_rows, Npad) output before the narrow fold. Rows past the
    matrix are zero (chain-padding strips carry zero panels), so ``Y``
    feeds a partner mono tiling directly (`mono_chain`)."""
    b = A.buckets[0]
    if not isinstance(b, MonoPanelBucket):
        raise NotImplementedError("the grouped mono layout is slice 3b")
    N = X.shape[1]
    (Xp, scale), NB, Npad, fold, nq = _prep_mono_x(A, X, N, precision)
    Y = mono_panel_spmm(
        b.window,
        b.strip_ptr,
        b.start_rel,
        b.panels,
        Xp,
        tile_m=A.tile_m,
        tile_k=A.tile_k,
        width=b.width,
        win_slabs=b.win_slabs,
        n_block=NB,
        fold=fold,
        out_rows=max(b.out_strips, A.n_strips) * A.tile_m,
        scale=scale if fold == "i8w" else None,
    )
    return Y, nq, Npad, scale


def _halo_impl(A, b, X, nq, precision):
    """Narrow product through the zero-spill halo layout ``A.narrow``: one
    item per strip, X planes addressed in place through the overlapping
    windows (the reference materializes a halo'd copy of X instead)."""
    TM, TK = A.tile_m, A.tile_k
    K_pad = ((b.n_windows - 1) * b.stride + b.win_slabs) * TK
    _require_int8_path(A, X.dtype, precision)
    nb = _round_up(3 * nq, 32)
    Xp, scale = _quant3_narrow(X, K_pad, nq, nb)
    Y = mono_group_spmm(
        b.windows,
        b.start_rel,
        b.panels,
        Xp,
        tile_m=TM,
        tile_k=TK,
        width=b.width,
        stride=b.stride,
        group=b.group,
    )
    Y = _fold_narrow_q(Y, nq, scale)
    return Y[: A.shape[0], : X.shape[1]]


def halo_nq(A, N: int, x_dtype=torch.float32, precision: str = "highest") -> int:
    """Padded width nq if the narrow halo engine serves this product, else
    0: the dispatch predicate of `_mono_impl`, as in the reference."""
    if getattr(A, "narrow", None) is None:
        return 0
    nq = _narrow_nq(N)
    if not nq or nq > HALO_NQ_MAX:
        return 0
    exact = A.binary or A.dtype in (torch.bfloat16, torch.int8)
    if not (exact and precision == "highest" and x_dtype == torch.float32):
        return 0
    return nq


def _mono_impl(A, X, precision):
    """``Y = A @ X`` in one kernel launch (plus the X encoding)."""
    nq = halo_nq(A, X.shape[1], X.dtype, precision)
    if nq:
        return _halo_impl(A, A.narrow, X, nq, precision)
    Y, nq, _, scale = _mono_raw(A, X, precision)
    if nq:
        Y = _fold_narrow_q(Y, nq, scale)
    return Y[: A.shape[0], : X.shape[1]]


def mono_chain(A, At, X, precision="highest"):
    """``Aᵀ(A X)`` as two back-to-back mono launches with no pad or trim
    copies between them: ``A``'s raw output is padded at build time to the
    X extent ``At``'s windows address. ``mono_chain(At, A, x)`` is the gram
    product ``AAᵀx``."""
    with tracing.span("bsr_ops"):
        return _mono_chain(A, At, X, precision)


def _mono_chain(A, At, X, precision):
    N = X.shape[1]
    Y1, nq1, Npad1, scale1 = _mono_raw(A, X, precision)
    if nq1:
        tmp = _fold_narrow_q(Y1, nq1, scale1)[:, :N]
    elif N == Npad1:
        tmp = Y1
    else:
        tmp = Y1[:, :N]
    Y2, nq2, _, scale2 = _mono_raw(At, tmp, precision)
    if nq2:
        Y2 = _fold_narrow_q(Y2, nq2, scale2)
    return Y2[: At.shape[0], :N]


def _require_parity(x_dtype, precision):
    if precision != "highest":
        raise NotImplementedError(
            f"precision={precision!r}: only 'highest' (fp32 parity) is ported"
        )
    if x_dtype != torch.float32:
        raise NotImplementedError(
            f"X dtype {x_dtype}: only float32 operands are ported (bf16 "
            "products are slice 3b)"
        )


def pick_strategy(n_slabs, tile_k, n_block, itemsize):
    """The reference's X placement for the tile kernel: "resident" while
    the X panel fits ``RESIDENT_VMEM_BUDGET``, else "streamed"."""
    if n_slabs * tile_k * n_block * itemsize > RESIDENT_VMEM_BUDGET:
        return "streamed"
    return "resident"


def _bucket_ranges(ns: int, T: int):
    """Part ranges ``(s0, s1, n_pad)`` of one bucket: at most
    ``_SMEM_IDX_BUDGET`` index entries each, every part of a chunked
    bucket padded to the same slot count."""
    ns_max = max(8, (_SMEM_IDX_BUDGET // max(T, 1)) // 8 * 8)
    if ns <= ns_max:
        yield 0, ns, ns
        return
    for s0 in range(0, ns, ns_max):
        yield s0, min(s0 + ns_max, ns), ns_max


def _bsr_layout(A):
    """THE part layout of a tile-bucket or class-panel BsrMatrix, shared
    by the products and the plan builders (`ops.assemble`): yields
    ``(bucket, s0, s1, n_pad)``, a part covering bucket slots [s0, s1)
    padded to ``n_pad`` (padding slots yield zero strip panels)."""
    for b in A.buckets:
        ns, T = (b.ns, 1) if isinstance(b, PanelBucket) else tuple(
            b.slab_ids.shape)
        for s0, s1, n_pad in _bucket_ranges(ns, T):
            yield b, s0, s1, n_pad


def _pad_part(Yb, n, n_pad, TM):
    """A part's kernel output ``(n·TM, Npad)`` as ``(n_pad, TM, Npad)``,
    zero panels for the padding slots."""
    Yb = Yb.reshape(n, TM, -1)
    if n_pad > n:
        tracing.count(2)
        Yb = torch.cat([Yb, Yb.new_zeros((n_pad - n,) + tuple(Yb.shape[1:]))])
    return Yb


def _part_sids(b, s0, s1, n_pad, nsp):
    sid = b.strip_ids[s0:s1]
    if n_pad > s1 - s0:
        tracing.count(2)
        sid = torch.cat([sid, sid.new_full((n_pad - (s1 - s0),), nsp)])
    return sid


def _split_bf16_planes(Xp):
    """f32 ``(K, N)`` -> bf16 planes ``(hi, h1, x2)`` with hi + h1 + x2 ≈ x
    to ~24 bits, split by masking the mantissa (as the reference does; hi
    and h1 are exact in bf16, x2 rounds once)."""
    mask = -65536  # 0xFFFF0000 as int32
    tracing.count(7 + int(not Xp.is_contiguous()))
    hi = (Xp.contiguous().view(torch.int32) & mask).view(torch.float32)
    r1 = Xp - hi
    h1 = (r1.view(torch.int32) & mask).view(torch.float32)
    x2 = r1 - h1
    return hi.to(torch.bfloat16), h1.to(torch.bfloat16), x2.to(torch.bfloat16)


def _stack_planes(Xp, NB: int, Npad: int):
    """f32 ``(K, Npad)`` -> bf16 ``(K, 3·Npad)``: the three planes stacked
    along the lanes per NB-wide block j, ``[x0_j | x1_j | x2_j]``."""
    K = Xp.shape[0]
    nj = Npad // NB
    planes = _split_bf16_planes(Xp)
    tracing.count()
    return torch.stack([p.reshape(K, nj, NB) for p in planes],
                       dim=2).reshape(K, nj * 3 * NB)


def _pack_narrow_planes(X, K: int, nq: int, nb: int = LANES):
    """f32 ``X (ncol, N)`` -> bf16 ``(K, nb)``: ``[x0 | x1 | x2 | 0]`` with
    each plane padded to ``nq`` columns and rows padded (or cut) to K."""
    ncol, N = X.shape
    Xf = X.to(torch.float32)
    if ncol > K:
        Xf = Xf[:K]
    Xf = _pad(Xf, (0, nq - N, 0, max(K - ncol, 0)))
    planes = list(_split_bf16_planes(Xf))
    if nb > 3 * nq:
        planes.append(Xf.new_zeros((K, nb - 3 * nq), dtype=torch.bfloat16))
    tracing.count(len(planes) - 2)
    return torch.cat(planes, dim=1)


def _fold_narrow(Y, nq: int):
    """Fold the narrow packing's three plane blocks: (d0 + d1) + d2."""
    tracing.count(2)
    return Y[:, :nq] + Y[:, nq : 2 * nq] + Y[:, 2 * nq : 3 * nq]


def _padded_x(X, K: int, Npad: int):
    tracing.count(2)
    Xp = X.new_zeros((K, Npad), dtype=torch.float32)
    Xp[: X.shape[0], : X.shape[1]] = X
    return Xp


def _tile_parts(A, Xp, n_block: int, planes: int, strategy: str):
    """Run `bucket_spmm` per part; returns (sids, parts)."""
    if strategy != "resident":
        raise NotImplementedError(
            "the streamed tile body (an X panel past the residency budget) "
            "is slice 3b"
        )
    TM, nsp = A.tile_m, A.n_strips
    sids, parts = [], []
    for b, s0, s1, n_pad in _bsr_layout(A):
        Yb = bucket_spmm(b.slab_ids[s0:s1], b.tiles[s0:s1], Xp,
                         n_block=n_block, planes=planes)
        sids.append(_part_sids(b, s0, s1, n_pad, nsp))
        parts.append(_pad_part(Yb, s1 - s0, n_pad, TM))
    return sids, parts


def _tile_impl(A, X, n_block, _parts):
    """Tile-bucket ``Y = A @ X`` (the reference's non-panel `bsr_spmm`)."""
    N = X.shape[1]
    TK, nsl = A.tile_k, A.n_slabs
    exact_bf16 = A.dtype == torch.bfloat16
    nq = _narrow_nq(N) if n_block is None and exact_bf16 else 0
    if nq:
        # narrow RHS: all three planes in one 128-lane block
        Xp = _pack_narrow_planes(X, nsl * TK, nq)
        strategy = pick_strategy(nsl, TK, LANES, 2)
        sids, parts = _tile_parts(A, Xp, LANES, 1, strategy)
        return _finish(A, sids, parts, LANES, nq, N, _parts)
    if n_block is None:
        n_block = min(_round_up(N, LANES), 512)
        # a wider RHS sweeps extra column blocks rather than widen X past
        # the residency budget
        while n_block > LANES and nsl * TK * n_block * 4 > RESIDENT_VMEM_BUDGET:
            n_block //= 2
    Npad = _round_up(N, n_block)
    Xp = _padded_x(X, nsl * TK, Npad)
    # bf16 tiles take the three-plane body ("planes_n") unless its X panel
    # would be streamed where plain f32 X stays resident
    planes = exact_bf16
    strategy = pick_strategy(nsl, TK, n_block, 6 if planes else 4)
    if planes and strategy == "streamed" and pick_strategy(
            nsl, TK, n_block, 4) == "resident":
        planes, strategy = False, "resident"
    if planes:
        Xp = _stack_planes(Xp, n_block, Npad)
    sids, parts = _tile_parts(A, Xp, n_block, 3 if planes else 1, strategy)
    return _finish(A, sids, parts, Npad, 0, N, _parts)


def _finish(A, sids, parts, Npad, nq, N, _parts):
    """Assemble the parts into Y (or hand them to `colseg_spmm`)."""
    if _parts:
        return sids, parts, Npad, nq
    Y = _assemble_rows(A, parts, Npad)
    if Y is None:
        Y = _assemble_strips(A, sids, parts, Npad)[: A.shape[0]]
    return (_fold_narrow(Y, nq) if nq else Y)[:, :N]


def _plan_ok(plan, parts, key):
    return (plan is not None and parts and plan.layout_key == key
            and plan.n_parts == sum(int(p.shape[0]) for p in parts))


def _assemble_rows(A, parts, Npad):
    """Row-granular assembly: one gather over the flattened part panels
    gives the exact ``(nrow, Npad)`` output. None without a valid plan."""
    from .assemble import bsr_layout_key

    plan = A.strip_plan
    if not _plan_ok(plan, parts, bsr_layout_key()) or plan.row_pos is None:
        return None
    tracing.count(4)
    cat = torch.cat([p.reshape(-1, Npad) for p in parts]
                    + [parts[0].new_zeros((1, Npad))])
    return cat[plan.row_pos.long()]


def _assemble_strips(A, sids, parts, Npad):
    """Part panels -> Y f32 ``(n_strips·TM, Npad)``: the plan's strip
    gather, else a scatter of the panels to their strips."""
    from .assemble import bsr_layout_key

    TM, nsp = A.tile_m, A.n_strips
    plan = A.strip_plan
    if _plan_ok(plan, parts, bsr_layout_key()):
        tracing.count(4)
        cat = torch.cat(parts + [parts[0].new_zeros((1, TM, Npad))])
        return cat[plan.pos.long()].reshape(nsp * TM, Npad)
    Y = torch.zeros((nsp + 1, TM, Npad), dtype=torch.float32,
                    device=A.device)
    tracing.count(5 if parts else 1)
    if parts:
        Y[torch.cat(sids).long()] = torch.cat(parts)
    return Y[:nsp].reshape(nsp * TM, Npad)


def _prep_panel_x(A, X, N):
    """Pad and encode X for the panel kernel: (Xp, Npad, fold, nq), with
    ``nq > 0`` for the narrow packing (folded after assembly)."""
    TK, nsl = A.tile_k, A.n_slabs
    parity = A.dtype in (torch.bfloat16, torch.int8)
    nq = _narrow_nq(N) if parity else 0
    if nq:
        return _pack_narrow_planes(X, nsl * TK, nq), LANES, False, nq
    Npad = _round_up(N, LANES)
    return _padded_x(X, nsl * TK, Npad), Npad, "f32" if parity else False, 0


def _panel_parts(A, Xp, fold, row_base: int = 0):
    """Run `panel_spmm` per part; ``row_base`` windows a global padded X
    (the column-segmented callers). Returns (sids, parts)."""
    TM, nsp = A.tile_m, A.n_strips
    sids, parts = [], []
    for b, s0, s1, n_pad in _bsr_layout(A):
        Yb = panel_spmm(b.start_slab[s0:s1], b.panels[s0:s1], Xp,
                        tile_k=A.tile_k, fold=fold, row_base=row_base)
        sids.append(_part_sids(b, s0, s1, n_pad, nsp))
        parts.append(_pad_part(Yb, s1 - s0, n_pad, TM))
    return sids, parts


def _panel_impl(A, X, _parts):
    N = X.shape[1]
    Xp, Npad, fold, nq = _prep_panel_x(A, X, N)
    sids, parts = _panel_parts(A, Xp, fold)
    return _finish(A, sids, parts, Npad, nq, N, _parts)


def bsr_spmm(A: BsrMatrix, X, *, n_block=None, precision: str = "highest",
             _parts: bool = False):
    """``Y = A @ X`` for a BsrMatrix. X: f32 (ncol, N) on the matrix's
    device. ``n_block`` pins the tile path's column block (`bsr_spmv`'s
    one-column fallback). ``_parts=True`` (`colseg_spmm`) returns the raw
    ``(sids, parts, Npad, nq)`` part panels instead of Y. An f64 X runs
    the COO engine over the layout's entries, as in the reference."""
    with tracing.span("bsr_ops"):
        return _bsr_spmm(A, X, n_block, precision, _parts)


def _bsr_spmm(A, X, n_block, precision, _parts):
    if not pallas_supported(X.dtype):
        if _parts:
            raise TypeError("_parts requires an operand dtype with a kernel")
        from .spmm import spmm as coo_spmm

        return coo_spmm(_as_coo(A, X.device), X)
    _require_parity(X.dtype, precision)
    if A.is_mono:
        if _parts:
            raise TypeError("mono layouts are never column segments")
        return _mono_impl(A, X, precision)
    if not A.buckets and not _parts:  # empty matrix
        tracing.count()
        return X.new_zeros((A.shape[0], X.shape[1]))
    if A.buckets and A.dtype not in (torch.bfloat16, torch.int8,
                                     torch.float32):
        raise NotImplementedError(
            f"{A.dtype} tiles: only bf16/int8 (0/1) and f32 tiles are ported"
        )
    if A.is_panel:
        return _panel_impl(A, X, _parts)
    return _tile_impl(A, X, n_block, _parts)


def _seg_mode(seg, N, x_dtype, precision):
    """(Npad, nq) the `bsr_spmm` paths produce for one segment: they must
    agree across segments for the cross-segment assembly."""
    exact = seg.dtype in (torch.bfloat16, torch.int8)
    parity = exact and precision == "highest" and x_dtype == torch.float32
    if seg.is_panel:
        nq = _narrow_nq(N) if parity else 0
        return (LANES, nq) if nq else (_round_up(N, LANES), 0)
    nq = _narrow_nq(N) if parity and seg.dtype == torch.bfloat16 else 0
    if nq:
        return LANES, nq
    nb = min(_round_up(N, LANES), 512)
    isz = 4 if x_dtype == torch.float32 else 2
    while nb > LANES and seg.n_slabs * seg.tile_k * nb * isz > RESIDENT_VMEM_BUDGET:
        nb //= 2
    return _round_up(N, nb), 0


def _colseg_panel_parts_global(A, X, N, Npad, nq):
    """All segments' panel parts over ONE globally padded X, each launch
    reading its segment's window of it (no per-segment X copies). Needs
    panel segments of one dtype with uniform, tile-aligned widths; None
    otherwise (the caller runs the segments one by one)."""
    segs = A.segments
    if not all(s.is_panel for s in segs):
        return None
    if len({s.dtype for s in segs}) != 1:
        return None
    seg_w, TK = A.seg_cols, segs[0].tile_k
    if seg_w % TK or any(off != i * seg_w
                         for i, off in enumerate(A.col_offsets)):
        return None
    x_rows = seg_w
    if any(s.n_slabs * TK > x_rows for s in segs):
        return None
    K_rows = len(segs) * x_rows
    parity = segs[0].dtype in (torch.bfloat16, torch.int8)
    if nq:
        Xg, fold = _pack_narrow_planes(X, K_rows, nq), False
    else:
        Xg, fold = _padded_x(X, K_rows, Npad), "f32" if parity else False
    parts_all = []
    for si, seg in enumerate(segs):
        parts_all += _panel_parts(seg, Xg, fold, row_base=si * x_rows)[1]
    return parts_all


def colseg_spmm(A, X, *, precision: str = "highest"):
    """Cross-segment ``Y = A @ X`` for a ColSegmented of BsrMatrix: all
    segments' strip panels summed by one gather plan
    (`ops.assemble.build_colseg_plan`). None when the plan is absent or the
    segments disagree on the product's mode (the caller then sums the
    segments' own products, as the reference does)."""
    with tracing.span("bsr_ops"):
        return _colseg_spmm(A, X, precision)


def _colseg_spmm(A, X, precision):
    from .assemble import colseg_layout_key

    segs = A.segments
    plan = A.plan
    if (plan is None or not segs or plan.layout_key != colseg_layout_key()
            or not all(isinstance(s, BsrMatrix) for s in segs)
            or not pallas_supported(X.dtype)):
        return None
    _require_parity(X.dtype, precision)
    N = X.shape[1]
    modes = {_seg_mode(s, N, X.dtype, precision) for s in segs}
    TM, nsp = segs[0].tile_m, segs[0].n_strips
    if len(modes) != 1 or any(s.tile_m != TM or s.n_strips != nsp
                              for s in segs):
        return None
    Npad, nq = modes.pop()
    parts_all = _colseg_panel_parts_global(A, X, N, Npad, nq)
    if parts_all is None:
        parts_all = []
        for off, seg in zip(A.col_offsets, segs):
            _, parts, Npad_s, nq_s = bsr_spmm(
                seg, X[off : off + seg.shape[1]], precision=precision,
                _parts=True)
            if (Npad_s, nq_s) != (Npad, nq):
                return None
            parts_all += parts
    if plan.n_slots != sum(int(p.shape[0]) for p in parts_all):
        return None
    Y = _colseg_sum(plan, parts_all, X, TM, Npad)
    if nq:
        Y = _fold_narrow(Y, nq)
    return Y[: A.shape[0], :N]


def _colseg_sum(plan, parts_all, X, TM, Npad):
    """The segments' ``(TM, Npad)`` strip panels summed into Y ``(rows,
    Npad)`` by the cross-segment plan (`ops.assemble.sum_plan`): row by
    row over its ``row_srcs`` where it has them (the matrix's rows), else
    strip by strip over its classes (every strip's rows)."""
    from .assemble import sum_plan

    tracing.count()
    pcat = torch.cat(parts_all) if parts_all else X.new_zeros((0, TM, Npad))
    if plan.row_srcs:
        return sum_plan(plan, pcat.view(-1, Npad))
    return sum_plan(plan, pcat.view(-1, TM * Npad)).view(-1, Npad)


def bsr_spmv(A: BsrMatrix, x):
    """``y = A @ x``: `bucket_spmv` per part for tile buckets (TM <= 32, x
    within the reference's residency budget); otherwise a one-column
    product (panel layouts, the halo engine for mono). An f64 x runs the
    COO engine over the layout's entries, as in the reference."""
    with tracing.span("bsr_ops"):
        return _bsr_spmv(A, x)


def _bsr_spmv(A, x):
    if not pallas_supported(x.dtype):
        from .spmv import spmv as coo_spmv

        return coo_spmv(_as_coo(A, x.device), x)
    _require_parity(x.dtype, "highest")
    nrow, ncol = A.shape
    TM, TK, nsp, nsl = A.tile_m, A.tile_k, A.n_strips, A.n_slabs
    if not A.buckets:
        tracing.count()
        return x.new_zeros((nrow,))
    if A.is_panel:
        return bsr_spmm(A, x[:, None])[:, 0]
    if nsl * TK * 4 > 12 * 1024 * 1024 or TM > 32:
        return bsr_spmm(A, x[:, None], n_block=LANES)[:, 0]
    if A.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"bucket_spmv over {A.dtype} tiles")
    xp = x.new_zeros((nsl * TK,))
    xp[:ncol] = x
    xp = xp.reshape(nsl, TK)
    y = x.new_zeros((nsp + 1, TM))
    tracing.count(3)
    for b in A.buckets:
        ns, T = b.slab_ids.shape
        for s0, s1, _ in _bucket_ranges(ns, T):
            tracing.count(2)
            y[b.strip_ids[s0:s1].long()] = bucket_spmv(
                b.slab_ids[s0:s1], b.tiles[s0:s1], xp)
    return y[:nsp].reshape(nsp * TM)[:nrow]
