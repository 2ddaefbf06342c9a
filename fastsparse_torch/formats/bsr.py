"""Block-sparse (BSR) layouts and their builder.

Counterpart of ``fastsparse/formats/bsr.py``. A matrix is cut into row
strips of ``tile_m`` rows and column slabs of ``tile_k`` columns, and
compiled into one of four layouts:

* mono (:class:`MonoPanelBucket`): the whole matrix as ONE list of
  uniform-width items, each a dense ``(tile_m, width·tile_k)`` panel of one
  strip reading a contiguous slice of X; beside it a zero-spill halo
  layout with one item per strip (:class:`MonoGroupBucket`,
  ``BsrMatrix.narrow``) serves narrow products (SpMV and N <= 8);
* class panels (:class:`PanelBucket`): one contiguous ``(tile_m,
  width·tile_k)`` panel per strip, strips grouped by width;
* tile buckets (:class:`BsrBucket`): each strip's occupied
  ``(tile_m, tile_k)`` tiles with their slab ids, strips grouped by
  power-of-two tile counts.

The layout decisions are host-side numpy and reproduce the reference's
exactly: same buckets, items, windows, widths, tiles and panels for the
same matrix and `Config`. The module constants below are layout
parameters of that decision (kept for parity, and monkeypatched by tests
in both packages), not limits of this card. Each fill is one
``index_put_`` on the target device.

Not ported yet (slice 3b), and refused with `NotImplementedError`:
bitmask tiles and panels (``binary=True``, ``binary_tiles="bitmask"``) and
the grouped mono layout.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..config import DEFAULT, Config
from .coo import COO, BinaryCOO

__all__ = [
    "BsrBucket",
    "PanelBucket",
    "MonoPanelBucket",
    "MonoGroupBucket",
    "BsrMatrix",
    "build_bsr",
]


def _ceil_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (int(x) - 1).bit_length()


def _to_np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@dataclasses.dataclass(frozen=True)
class BsrBucket:
    """All row strips needing exactly ``ntiles`` (padded) tiles.

    Slot ``i`` covers strip ``strip_ids[i]`` (``n_strips`` for a padding
    slot); its tile ``t`` reads X rows from ``slab_ids[i, t]·tile_k`` on
    (padding tiles read slab 0 and hold zeros)."""

    strip_ids: torch.Tensor  # int32[ns]
    slab_ids: torch.Tensor  # int32[ns, T]
    tiles: torch.Tensor  # dtype[ns, T, TM, TK]
    ntiles: int

    @property
    def ns(self) -> int:
        return int(self.strip_ids.shape[0])


@dataclasses.dataclass(frozen=True)
class PanelBucket:
    """One panel class: strips whose occupied slabs span ``width``
    contiguous slabs. Slot ``i`` is ONE ``(TM, width·TK)`` block of strip
    ``strip_ids[i]`` (``n_strips`` for a padding slot) starting at column
    ``start_slab[i]·tile_k``."""

    strip_ids: torch.Tensor  # int32[ns]
    start_slab: torch.Tensor  # int32[ns]
    panels: torch.Tensor  # dtype[ns, TM, width·TK]
    width: int

    @property
    def ns(self) -> int:
        return int(self.strip_ids.shape[0])

    @property
    def ntiles(self) -> int:  # tile-equivalents
        return self.width


@dataclasses.dataclass(frozen=True)
class MonoPanelBucket:
    """The whole matrix as ONE uniform-width panel work list.

    Item ``i`` covers output strip ``strip_ids[i]`` (ascending) and reads X
    rows from ``(window[i]·win_slabs + start_rel[i])·tile_k`` on;
    ``first[i]`` marks a strip's first item. Every strip in
    ``[0, out_strips)`` has at least one item (empty strips carry a zero
    item), and ``strip_ptr[s]`` is the index of strip ``s``'s first item,
    which the CUDA kernel uses to give each output strip to one block.
    ``out_strips`` pads past the matrix's own strips up to the transpose
    tiling's X extent, so a normal-equation chain feeds the raw output of
    one product to the next with no copies."""

    strip_ids: torch.Tensor  # int32[ni], ascending
    window: torch.Tensor  # int32[ni]
    start_rel: torch.Tensor  # int32[ni], slabs relative to the window
    first: torch.Tensor  # int32[ni]
    panels: torch.Tensor  # dtype[ni, TM, width·TK]
    strip_ptr: torch.Tensor  # int32[out_strips + 1]
    width: int
    win_slabs: int
    n_windows: int
    out_strips: int

    @classmethod
    def from_items(cls, strip_ids, window, start_rel, first, panels, *,
                   width, win_slabs, n_windows, out_strips):
        """Validate an item list and derive ``strip_ptr``; index arrays go
        to the panels' device as int32."""
        sid = _to_np(strip_ids).astype(np.int64)
        win = _to_np(window).astype(np.int64)
        st = _to_np(start_rel).astype(np.int64)
        fst = _to_np(first).astype(np.int64)
        starts = np.ones(sid.size, bool)
        starts[1:] = sid[1:] != sid[:-1]
        ok = (
            (np.diff(sid) >= 0).all()
            and (sid.size == 0 or (sid[0] >= 0 and sid[-1] < out_strips))
            and (fst == starts).all()
            and (st >= 0).all()
            and (st + width <= win_slabs).all()
            and ((win >= 0) & (win < n_windows)).all()
        )
        if not ok:
            raise ValueError(
                "mono item list must be sorted by strip, flag each strip's "
                "first item, and keep every panel inside its window"
            )
        ptr = np.searchsorted(sid, np.arange(out_strips + 1), side="left")
        dev = panels.device

        def i32(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=dev)

        return cls(
            strip_ids=i32(sid), window=i32(win), start_rel=i32(st),
            first=i32(fst), panels=panels, strip_ptr=i32(ptr),
            width=int(width), win_slabs=int(win_slabs),
            n_windows=int(n_windows), out_strips=int(out_strips),
        )

    @property
    def ns(self) -> int:
        return int(self.strip_ids.shape[0])


@dataclasses.dataclass(frozen=True)
class MonoGroupBucket:
    """Exactly ONE uniform-width item per output strip, ``group`` strips
    sharing one X window; here the zero-spill halo layout of the narrow
    engine. Window ``w`` covers slabs ``[w·stride, w·stride + win_slabs)``
    (overlapping when ``win_stride < win_slabs``); strip ``s`` reads X
    from slab ``windows[s // group]·stride + start_rel[s]``."""

    windows: torch.Tensor  # int32[ns // group]
    start_rel: torch.Tensor  # int32[ns]
    panels: torch.Tensor  # dtype[ns, TM, width·TK]
    width: int
    win_slabs: int
    n_windows: int
    group: int
    out_strips: int = 0
    win_stride: int = 0

    @property
    def stride(self) -> int:
        return self.win_stride or self.win_slabs

    @property
    def ns(self) -> int:
        return int(self.start_rel.shape[0])


_PANEL_KINDS = (PanelBucket, MonoPanelBucket, MonoGroupBucket)


@dataclasses.dataclass(frozen=True)
class BsrMatrix:
    """A matrix compiled into bucketed (tile_m × tile_k) tiles, class
    panels or the mono layout (an empty matrix has no buckets). ``shape``
    is the logical shape; ``n_strips`` and ``n_slabs`` count the padded
    tile grid."""

    buckets: Tuple[Any, ...]
    shape: tuple
    nnz: int
    n_tiles: int  # occupied (tile_m × tile_k) tiles
    padded_tiles: int  # stored slab-equivalents
    tile_m: int
    tile_k: int
    binary: bool
    # strip-gather Y assembly of the tile and class-panel layouts
    # (`ops.assemble.BsrStripPlan`), or None
    strip_plan: Any = None
    # narrow-RHS halo engine (SpMV and N <= 8), or None
    narrow: Optional[MonoGroupBucket] = None

    @property
    def n_strips(self) -> int:
        return -(-self.shape[0] // self.tile_m)

    @property
    def n_slabs(self) -> int:
        return -(-self.shape[1] // self.tile_k)

    def _values(self):
        b = self.buckets[0]
        return b.panels if isinstance(b, _PANEL_KINDS) else b.tiles

    @property
    def dtype(self):
        if self.binary or not self.buckets:
            return torch.float32
        return self._values().dtype

    @property
    def device(self):
        return self._values().device if self.buckets else None

    @property
    def is_panel(self) -> bool:
        return bool(self.buckets) and isinstance(self.buckets[0], _PANEL_KINDS)

    @property
    def is_mono(self) -> bool:
        return bool(self.buckets) and isinstance(
            self.buckets[0], (MonoPanelBucket, MonoGroupBucket)
        )

    @property
    def is_mono_grouped(self) -> bool:
        return bool(self.buckets) and isinstance(
            self.buckets[0], MonoGroupBucket
        )

    def todense(self) -> torch.Tensor:
        """Dense f32 (int8 panels densify as f32) or tile-dtype matrix."""
        TM, TK = self.tile_m, self.tile_k
        nsp, nsl = self.n_strips, self.n_slabs
        ddt = torch.float32 if self.dtype == torch.int8 else self.dtype
        if not self.buckets:
            return torch.zeros(self.shape, dtype=ddt)
        if not self.is_mono:
            return self._todense_strips(ddt)
        dev = self.buckets[0].panels.device
        wide = nsl * TK
        for b in self.buckets:
            wide = max(wide, b.n_windows * b.win_slabs * TK)
        outp = torch.zeros((nsp + 1, TM, wide), dtype=ddt, device=dev)
        for b in self.buckets:
            PK = b.width * TK
            start = (b.window.long() * b.win_slabs + b.start_rel.long())
            cols = start[:, None] * TK + torch.arange(PK, device=dev)[None, :]
            # chain-padding strips past n_strips fold into the dump strip
            sids = b.strip_ids.long().clamp(max=nsp)
            idx = (
                sids[:, None, None].expand(-1, TM, PK),
                torch.arange(TM, device=dev)[None, :, None].expand(b.ns, -1, PK),
                cols[:, None, :].expand(-1, TM, -1),
            )
            outp.index_put_(idx, b.panels.to(ddt), accumulate=True)
        dense = outp[:nsp, :, : nsl * TK].reshape(nsp * TM, nsl * TK)
        return dense[: self.shape[0], : self.shape[1]]

    def _todense_strips(self, ddt) -> torch.Tensor:
        """Tile buckets and class panels: each slot's block added at its
        strip (padding slots land in the dump strip ``n_strips``)."""
        TM, TK = self.tile_m, self.tile_k
        nsp, nsl = self.n_strips, self.n_slabs
        dev = self.device
        outp = torch.zeros((nsp + 1, TM, nsl * TK), dtype=ddt, device=dev)
        ar_m = torch.arange(TM, device=dev)
        for b in self.buckets:
            sids = b.strip_ids.long()
            if isinstance(b, PanelBucket):
                PK = b.width * TK
                cols = (b.start_slab.long()[:, None] * TK
                        + torch.arange(PK, device=dev)[None, :])
                idx = (sids[:, None, None].expand(-1, TM, PK),
                       ar_m[None, :, None].expand(b.ns, -1, PK),
                       cols[:, None, :].expand(-1, TM, -1))
                outp.index_put_(idx, b.panels.to(ddt), accumulate=True)
                continue
            T = b.ntiles
            cols = (b.slab_ids.long()[:, :, None] * TK
                    + torch.arange(TK, device=dev))  # (ns, T, TK)
            idx = (sids[:, None, None, None].expand(-1, T, TM, TK),
                   ar_m[None, None, :, None].expand(b.ns, T, -1, TK),
                   cols[:, :, None, :].expand(-1, -1, TM, -1))
            outp.index_put_(idx, b.tiles.to(ddt), accumulate=True)
        dense = outp[:nsp].reshape(nsp * TM, nsl * TK)
        return dense[: self.shape[0], : self.shape[1]]


# ------------------------------------------------------------ layout model
# Allowed panel widths (slabs), as in the reference.
_PANEL_WIDTHS = (
    1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 24, 32, 40, 48, 64, 80, 96,
    128, 160, 192, 256, 320, 384, 512,
)
# Widest class panel the reference's class-panel layout accepts; it enters
# the mono decision through that layout's footprint.
PANEL_W_MAX = 16

# Mono geometry: X window (slabs), item-width cap (slabs), the per-item
# cost in slab-equivalents of the width model, the item-count cap and the
# footprint factor against the best alternative layout.
MONO_WIN_SLABS = 80
MONO_W_MAX = 12
MONO_ITEM_SLABS = 2
MONO_MAX_ITEMS = 48_000
MONO_BYTES_FACTOR = 1.35

# Halo layout: strips per group (halved while over the panel allowance),
# window stride cap, window cap (slabs) and panel-block byte allowance.
MONO_GROUP_MAX = 8
HALO_STRIDE = 160
HALO_WIN_MAX = 512
HALO_PANEL_VMEM = 4 * 2**20


def _quantize_widths(wc: np.ndarray, n_slabs: int) -> np.ndarray:
    """Round contiguous widths up the panel ladder, clamped to n_slabs."""
    ladder = np.asarray([w for w in _PANEL_WIDTHS if w < n_slabs] + [n_slabs])
    idx = np.searchsorted(ladder, wc, side="left")
    return ladder[np.minimum(idx, ladder.size - 1)]


def _round8(x: int) -> int:
    return -(-int(x) // 8) * 8


def _merge_panel_classes(wq: np.ndarray, ne: np.ndarray) -> np.ndarray:
    """Merge width classes upward while the padded footprint does not grow
    (every class pads its strip count to a multiple of 8, at least 8)."""
    wq = wq.copy()
    while True:
        ws = np.unique(wq[ne])
        merged = False
        for i in range(len(ws) - 1):
            w1, w2 = int(ws[i]), int(ws[i + 1])
            c1 = int((wq == w1).sum())
            c2 = int((wq == w2).sum())
            old = _round8(max(c1, 8)) * w1 + _round8(max(c2, 8)) * w2
            new = _round8(max(c1 + c2, 8)) * w2
            if new <= old:
                wq[wq == w1] = w2
                merged = True
                break
        if not merged:
            return wq


def _panel_footprint(wq: np.ndarray, ne: np.ndarray) -> int:
    slabs = 0
    for w in np.unique(wq[ne]):
        slabs += _round8(max(int((wq == w).sum()), 8)) * int(w)
    return slabs


def _mono_pieces(smin, smax, ne, win_slabs):
    """Window-split every nonempty strip's span into pieces (strip, lo,
    length) that never cross a window boundary, in (strip, lo) order."""
    strips = np.nonzero(ne)[0]
    lo_s, hi_s = smin[strips], smax[strips]
    w0 = lo_s // win_slabs
    w1 = hi_s // win_slabs
    npc = (w1 - w0 + 1).astype(np.int64)
    p_strip = np.repeat(strips, npc)
    p_win = np.repeat(w0, npc) + (
        np.arange(npc.sum()) - np.repeat(np.cumsum(npc) - npc, npc)
    )
    p_lo = np.maximum(np.repeat(lo_s, npc), p_win * win_slabs)
    p_hi = np.minimum(np.repeat(hi_s, npc), (p_win + 1) * win_slabs - 1)
    return p_strip, p_lo, p_hi - p_lo + 1


def _mono_pad_strips(nrow: int, TM: int, TK: int) -> int:
    """Output row blocks a mono build covers: the matrix's own strips,
    padded up to whole X windows of the transpose tiling's geometry, so
    its raw output is directly the partner tiling's X operand."""
    n_slabs_t = max(-(-nrow // TK), 1)
    win = min(MONO_WIN_SLABS, n_slabs_t)
    pad_rows = -(-n_slabs_t // win) * win * TK
    pad_rows = max(pad_rows, -(-nrow // TM) * TM)
    return -(-pad_rows // TM)


def _mono_width(p_len: np.ndarray, win_slabs: int, n_empty: int):
    """Uniform item width W from the panel ladder minimizing the modeled
    cost ``items·(W + MONO_ITEM_SLABS)`` in slab-equivalents."""
    cap = min(win_slabs, MONO_W_MAX)
    best_w, best_cost = None, None
    for w in [x for x in _PANEL_WIDTHS if x <= cap] or [cap]:
        items = int(np.sum(-(-p_len // w))) + n_empty
        cost = items * (w + MONO_ITEM_SLABS)
        if best_cost is None or cost < best_cost:
            best_w, best_cost = w, cost
    return best_w, best_cost


def _mono_item_list(p_strip, p_lo, p_len, W, win_slabs, cover_strips):
    """Chunk pieces into uniform-width items, plus zero items for strips
    in ``[0, cover_strips)`` that have none. Returns (it_strip, it_lo,
    it_win, it_start, first) sorted by (strip, lo)."""
    nch = (-(-p_len // W)).astype(np.int64)
    ni_real = int(nch.sum())
    it_strip = np.repeat(p_strip, nch)
    k = np.arange(ni_real) - np.repeat(np.cumsum(nch) - nch, nch)
    it_lo = np.repeat(p_lo, nch) + k * W
    it_win = it_lo // win_slabs
    # left-clamp so the whole W-wide panel stays inside the item's window
    it_start = np.minimum(it_lo, (it_win + 1) * win_slabs - W)
    empty = np.setdiff1d(
        np.arange(cover_strips, dtype=np.int64), np.unique(it_strip)
    )
    if empty.size:
        it_strip = np.concatenate([it_strip, empty])
        it_lo = np.concatenate([it_lo, np.zeros(empty.size, np.int64)])
        it_win = np.concatenate([it_win, np.zeros(empty.size, np.int64)])
        it_start = np.concatenate([it_start, np.zeros(empty.size, np.int64)])
        order = np.argsort(it_strip, kind="stable")
        it_strip, it_lo, it_win, it_start = (
            a[order] for a in (it_strip, it_lo, it_win, it_start)
        )
    ni = it_strip.size
    first = np.ones(ni, np.int32)
    first[1:] = (it_strip[1:] != it_strip[:-1]).astype(np.int32)
    return it_strip, it_lo, it_win, it_start, first


def _mono_vals(coo, is_bin_in, dtype, n, device):
    """Value vector of the entry list on ``device``."""
    if is_bin_in:
        return torch.ones(n, dtype=dtype or torch.float32, device=device)
    v = coo.vals[: coo.n_valid].to(device)
    return v if dtype is None else v.to(dtype)


def _mono_fill(rows, cols, item, start_abs, ni, TM, TK, W, vals_dev):
    """One flat device scatter of the entries into (ni, TM, W·TK) panels."""
    PK = W * TK
    per = TM * PK
    slot = item * per + (rows % TM) * PK + (cols - start_abs[item] * TK)
    dev = vals_dev.device
    flat = torch.zeros(ni * per, dtype=vals_dev.dtype, device=dev)
    flat.index_put_(
        (torch.as_tensor(slot, dtype=torch.int64, device=dev),),
        vals_dev, accumulate=True,
    )
    return flat.reshape(ni, TM, PK)


def _build_mono(
    rows, cols, coo, is_bin_in, dtype, shape,
    n_strips, n_slabs, TM, TK, W, win_slabs,
    p_strip, p_lo, p_len, n_tiles, device,
) -> BsrMatrix:
    """Mono-panel build: the uniform-width item list + one panel fill."""
    nrow, ncol = shape
    n_windows = max(-(-n_slabs // win_slabs), 1)
    out_strips = max(n_strips, _mono_pad_strips(nrow, TM, TK))
    it_strip, it_lo, it_win, it_start, first = _mono_item_list(
        p_strip, p_lo, p_len, W, win_slabs, out_strips
    )
    ni = it_strip.size
    # entry -> the last item of its strip whose chunk lo <= its slab
    key_it = it_strip * np.int64(n_slabs + 1) + it_lo
    key_en = (rows // TM) * np.int64(n_slabs + 1) + cols // TK
    item = np.searchsorted(key_it, key_en, side="right") - 1
    vals_dev = _mono_vals(coo, is_bin_in, dtype, rows.shape[0], device)
    panels = _mono_fill(rows, cols, item, it_start, ni, TM, TK, W, vals_dev)
    bucket = MonoPanelBucket.from_items(
        it_strip, it_win, it_start - it_win * win_slabs, first, panels,
        width=W, win_slabs=win_slabs, n_windows=n_windows,
        out_strips=out_strips,
    )
    return BsrMatrix(
        buckets=(bucket,),
        shape=(nrow, ncol),
        nnz=int(rows.shape[0]),
        n_tiles=n_tiles,
        padded_tiles=ni * int(W),
        tile_m=TM,
        tile_k=TK,
        binary=False,
    )


def _build_mono_halo(
    rows, cols, coo, is_bin_in, dtype, shape,
    n_strips, n_slabs, TM, TK, smin, smax, ne, device,
):
    """Zero-spill halo layout (narrow-RHS engine), or None.

    One uniform-width item per strip, G strips per group sharing one X
    window, windows overlapping so that every group provably fits its
    window (``win_slabs = stride + gspan_max - 1``). Declines when one
    strip's span exceeds the width cap or the window/panel caps bind."""
    nrow, ncol = shape
    if not ne.any():
        return None
    W_span = int((smax - smin + 1)[ne].max())
    W = int(_quantize_widths(np.asarray([W_span]), n_slabs)[0])
    if W > min(MONO_W_MAX, n_slabs) or W < W_span:
        return None  # some strip would spill regardless of windows
    PK = W * TK
    row_bytes = PK * (
        1 if dtype == torch.int8 else (4 if dtype == torch.float32 else 2)
    )
    BIG = np.int64(1) << 60
    G = MONO_GROUP_MAX
    while G >= 1:
        out_strips = max(n_strips, _mono_pad_strips(nrow, TM, TK))
        out_strips = -(-out_strips // G) * G
        ng = out_strips // G
        smin_f = np.full(out_strips, BIG, np.int64)
        smax_f = np.zeros(out_strips, np.int64)
        smin_f[:n_strips][ne] = smin[ne]
        smax_f[:n_strips][ne] = smax[ne]
        gmin = smin_f.reshape(ng, G).min(axis=1)
        gmax = smax_f.reshape(ng, G).max(axis=1)
        ne_g = gmin < BIG
        gspan = int((gmax - gmin + 1)[ne_g].max()) if ne_g.any() else 1
        stride = min(HALO_STRIDE, n_slabs)
        win_slabs = min(stride + gspan - 1, n_slabs)
        stride = min(stride, win_slabs)
        panel_ok = 2 * G * TM * row_bytes <= HALO_PANEL_VMEM
        win_ok = win_slabs <= HALO_WIN_MAX
        if panel_ok and win_ok:
            break
        G //= 2
    else:
        return None
    if G < 2:
        return None  # no grouping left: the per-item mono path serves
    n_windows = max(-(-max(n_slabs - win_slabs, 0) // stride) + 1, 1)
    gw = np.where(ne_g, np.minimum(gmin, BIG - 1) // stride, 0)
    gw = np.minimum(gw, max(n_windows - 1, 0))
    gw_s = np.repeat(gw, G)
    start = np.clip(
        np.where(smin_f < BIG, smin_f, gw_s * stride),
        gw_s * stride,
        gw_s * stride + win_slabs - W,
    )
    strip = rows // TM
    slab = cols // TK
    if ((slab < start[strip]) | (slab >= start[strip] + W)).any():
        return None  # coverage proof failed: decline
    vals_dev = _mono_vals(coo, is_bin_in, dtype, rows.shape[0], device)
    panels = _mono_fill(rows, cols, strip, start, out_strips, TM, TK, W,
                        vals_dev)
    return MonoGroupBucket(
        windows=torch.as_tensor(gw.astype(np.int32), device=device),
        start_rel=torch.as_tensor(
            (start - gw_s * stride).astype(np.int32), device=device
        ),
        panels=panels,
        width=int(W),
        win_slabs=int(win_slabs),
        n_windows=int(n_windows),
        group=int(G),
        out_strips=int(out_strips),
        win_stride=int(stride),
    )


def build_bsr(
    mat, config: Config = DEFAULT, dtype=None, binary=None, panels=None,
    mono_only: bool = False, device="cuda",
) -> BsrMatrix:
    """Compile a COO matrix into a BSR layout on ``device``.

    Takes the reference's layout decision (`fastsparse.formats.bsr.
    build_bsr`): mono when its padded footprint is within
    ``MONO_BYTES_FACTOR`` of the best alternative layout, else class panels
    when their footprint is no larger than the tile buckets' (and X fits
    the panel kernels' residency cap), else tile buckets. ``panels=True``
    or ``False`` forces the class-panel layout or keeps it out, as in the
    reference. ``mono_only=True`` returns None unless mono wins. An empty
    matrix compiles to a layout with no buckets.

    A 0/1 input (`BinaryCOO`) stores its values as int8 in panel layouts
    (the ``binary_tiles="int8"`` default) and as bf16 in tile buckets.
    Bitmask tiles (``binary=True``, ``binary_tiles="bitmask"``, or a binary
    input with a ``dtype``) and the grouped mono layout raise
    `NotImplementedError`: they are slice 3b.
    """
    config = config.resolve()
    TM, TK = config.tile_m, config.tile_k
    if TK % 32:
        raise ValueError("tile_k must be a multiple of 32")
    if isinstance(mat, (COO, BinaryCOO)):
        coo = mat
    else:
        raise TypeError(f"unsupported input {type(mat).__name__}")
    is_bin_in = isinstance(coo, BinaryCOO)
    int8_tiles = False
    if binary is None and is_bin_in and dtype is None and (
            config.binary_tiles in ("bf16", "int8")):
        # 0/1 values stored as bf16 tiles (exact), int8 in panel layouts
        dtype = torch.bfloat16
        int8_tiles = config.binary_tiles == "int8"
    elif binary or (binary is None and is_bin_in):
        raise NotImplementedError(
            "bitmask tiles (binary=True, binary_tiles='bitmask', or a binary "
            "input with a dtype) are slice 3b"
        )

    nrow, ncol = coo.shape
    n_strips = -(-nrow // TM)
    n_slabs = max(-(-ncol // TK), 1)
    rows = coo.rows[: coo.n_valid].cpu().numpy().astype(np.int64)
    cols = coo.cols[: coo.n_valid].cpu().numpy().astype(np.int64)

    # occupied tiles, their strips, and each entry's tile rank in its strip
    upair, inv = np.unique((rows // TM) * n_slabs + cols // TK,
                           return_inverse=True)
    ustrip = upair // n_slabs
    uslab = upair % n_slabs
    tiles_per_strip = np.bincount(ustrip, minlength=n_strips)
    first_of_strip = np.zeros(n_strips, np.int64)
    np.cumsum(tiles_per_strip[:-1], out=first_of_strip[1:])
    urank = np.arange(upair.size) - first_of_strip[ustrip]

    # strips bucketed by padded tile count (power-of-two slot counts)
    widths = sorted(set(int(t) for t in config.bsr_bucket_tiles))
    max_needed = int(tiles_per_strip.max()) if upair.size else 1
    if max_needed > widths[-1]:
        widths.append(_ceil_pow2(max_needed))
    T_of_strip = np.zeros(n_strips, np.int64)
    for w in reversed(widths):
        T_of_strip[tiles_per_strip <= w] = w
    T_of_strip[tiles_per_strip == 0] = 0
    buckets_meta = []  # (T, strips in the bucket, padded ns, first tile slot)
    tile_base_of_strip = np.zeros(n_strips, np.int64)
    flat_tiles = 0
    for w in widths:
        strips_b = np.nonzero(T_of_strip == w)[0]
        if strips_b.size == 0:
            continue
        ns = _ceil_pow2(max(strips_b.size, 8))
        buckets_meta.append((w, strips_b, ns, flat_tiles))
        tile_base_of_strip[strips_b] = flat_tiles + np.arange(strips_b.size) * w
        flat_tiles += ns * w

    if panels is None and config.bsr_panels != "auto":
        panels = False
    from ..config import BSR_SEG_COLS_F32

    # class panels hold the whole X panel resident in the reference (f32,
    # its planes split in-kernel), so they are gated on the f32 column cap
    classes_ok = n_slabs * TK <= BSR_SEG_COLS_F32
    mono_mode = config.bsr_mono
    if (panels is not False or mono_mode == "force") and upair.size:
        last = first_of_strip + np.maximum(tiles_per_strip - 1, 0)
        smin = np.zeros(n_strips, np.int64)
        smax = np.zeros(n_strips, np.int64)
        ne = tiles_per_strip > 0
        smin[ne] = uslab[first_of_strip[ne]]
        smax[ne] = uslab[last[ne]]
        wq = np.zeros(n_strips, np.int64)
        wq[ne] = _quantize_widths((smax - smin + 1)[ne], n_slabs)
        wq = _merge_panel_classes(wq, ne)
        panel_slabs = (
            _panel_footprint(wq, ne)
            if (not ne.any() or int(wq[ne].max()) <= PANEL_W_MAX)
            else 0
        )
        mono_plan = None
        if mono_mode in ("auto", "force"):
            win_slabs = min(MONO_WIN_SLABS, n_slabs)
            p_strip, p_lo, p_len = _mono_pieces(smin, smax, ne, win_slabs)
            W, _ = _mono_width(p_len, win_slabs, int((~ne).sum()))
            n_items = int(np.sum(-(-p_len // W))) + int((~ne).sum())
            if n_items <= MONO_MAX_ITEMS:
                mono_plan = (W, win_slabs, p_strip, p_lo, p_len, n_items * W)
        best_alt = min(flat_tiles, panel_slabs) if panel_slabs else flat_tiles
        if mono_plan is not None and (
            mono_mode == "force"
            or mono_plan[5] <= MONO_BYTES_FACTOR * max(best_alt, 1)
        ):
            if config.bsr_mono_grouped:
                raise NotImplementedError(
                    "the grouped mono layout (bsr_mono_grouped=True) is "
                    "slice 3b"
                )
            W, win_slabs, p_strip, p_lo, p_len, _ = mono_plan
            mono_dtype = torch.int8 if int8_tiles else dtype
            m = _build_mono(
                rows, cols, coo, is_bin_in, mono_dtype, (nrow, ncol),
                n_strips, n_slabs, TM, TK, W, win_slabs,
                p_strip, p_lo, p_len, int(upair.size), device,
            )
            h = _build_mono_halo(
                rows, cols, coo, is_bin_in, mono_dtype, (nrow, ncol),
                n_strips, n_slabs, TM, TK, smin, smax, ne, device,
            )
            return dataclasses.replace(m, narrow=h) if h is not None else m
        if mono_only:
            return None
        # ties go to panels: equal bytes, one contiguous slice per strip
        if (classes_ok or panels is True) and panels is not False and (
            panels is True or 0 < panel_slabs <= flat_tiles
        ):
            return _build_panels(
                rows, cols, coo, is_bin_in,
                torch.int8 if int8_tiles else dtype, (nrow, ncol),
                n_strips, n_slabs, TM, TK, wq, smin, int(upair.size), device,
            )
    if mono_only:
        return None
    return _build_tiles(
        rows, cols, coo, is_bin_in, dtype, (nrow, ncol), n_strips, TM, TK,
        buckets_meta, tile_base_of_strip[ustrip] + urank, inv, uslab,
        flat_tiles, device,
    )


def _flat_fill(slot, n, vals_dev):
    """One device scatter-add of the entry values into a flat buffer."""
    dev = vals_dev.device
    flat = torch.zeros(n, dtype=vals_dev.dtype, device=dev)
    flat.index_put_((torch.as_tensor(slot, dtype=torch.int64, device=dev),),
                    vals_dev, accumulate=True)
    return flat


def _build_tiles(rows, cols, coo, is_bin_in, dtype, shape, n_strips, TM, TK,
                 buckets_meta, tile_slot_of_u, inv, uslab, flat_tiles,
                 device) -> BsrMatrix:
    """Tile-bucket build: every entry lands in its tile's slot of one flat
    fill; each bucket is a slice of it."""
    nrow, ncol = shape
    per = TM * TK
    slot = tile_slot_of_u[inv] * per + (rows % TM) * TK + cols % TK
    vals_dev = _mono_vals(coo, is_bin_in, dtype, rows.shape[0], device)
    flat = _flat_fill(slot, flat_tiles * per, vals_dev)
    slab_of_slot = np.zeros(max(flat_tiles, 1), np.int32)
    slab_of_slot[tile_slot_of_u] = uslab
    buckets = []
    for w, strips_b, ns, base in buckets_meta:
        strip_ids = np.full(ns, n_strips, np.int32)
        strip_ids[: strips_b.size] = strips_b
        buckets.append(BsrBucket(
            strip_ids=torch.as_tensor(strip_ids, device=device),
            slab_ids=torch.as_tensor(
                slab_of_slot[base : base + ns * w].reshape(ns, w),
                device=device),
            tiles=flat[base * per : (base + ns * w) * per].reshape(
                ns, w, TM, TK),
            ntiles=int(w),
        ))
    return BsrMatrix(
        buckets=tuple(buckets), shape=(nrow, ncol), nnz=int(rows.shape[0]),
        n_tiles=int(uslab.size), padded_tiles=int(flat_tiles), tile_m=TM,
        tile_k=TK, binary=False,
    )


def _build_panels(rows, cols, coo, is_bin_in, dtype, shape, n_strips,
                  n_slabs, TM, TK, wq, smin, n_tiles, device) -> BsrMatrix:
    """Class-panel build: one contiguous (TM, W·TK) block per strip, strips
    grouped by their ladder width ``wq`` (0 = empty), each class padded to
    a multiple of 8 slots, one flat fill."""
    nrow, ncol = shape
    ne = wq > 0
    classes = np.unique(wq[ne]) if ne.any() else np.asarray([1], np.int64)
    # start clamped so that start + W <= n_slabs (X slices stay in bounds)
    start = np.zeros(n_strips, np.int64)
    start[ne] = np.minimum(smin[ne], n_slabs - wq[ne])
    base = np.zeros(n_strips, np.int64)  # flat element offset of each panel
    meta = []
    off = 0
    for w in classes:
        strips_c = np.nonzero(wq == w)[0]
        ns_pad = _round8(max(strips_c.size, 8))
        per = TM * int(w) * TK
        meta.append((int(w), strips_c, ns_pad, off))
        base[strips_c] = off + np.arange(strips_c.size) * per
        off += ns_pad * per
    strip = rows // TM
    slot = (base[strip] + (rows % TM) * (wq[strip] * TK)
            + cols - start[strip] * TK)
    vals_dev = _mono_vals(coo, is_bin_in, dtype, rows.shape[0], device)
    flat = _flat_fill(slot, off, vals_dev)
    buckets = []
    padded = 0
    for w, strips_c, ns_pad, cbase in meta:
        PK = w * TK
        strip_ids = np.full(ns_pad, n_strips, np.int32)
        strip_ids[: strips_c.size] = strips_c
        st = np.zeros(ns_pad, np.int32)
        st[: strips_c.size] = start[strips_c]
        buckets.append(PanelBucket(
            strip_ids=torch.as_tensor(strip_ids, device=device),
            start_slab=torch.as_tensor(st, device=device),
            panels=flat[cbase : cbase + ns_pad * TM * PK].reshape(
                ns_pad, TM, PK),
            width=w,
        ))
        padded += ns_pad * w
    return BsrMatrix(
        buckets=tuple(buckets), shape=(nrow, ncol), nnz=int(rows.shape[0]),
        n_tiles=n_tiles, padded_tiles=padded, tile_m=TM, tile_k=TK,
        binary=False,
    )
