"""Layout-selection model (counterpart of ``fastsparse/bench/model.py``).

`operator()` uses it to pick the auto tile height (`best_tile_m`) and, for
``format="auto"``, to choose between the tile path, the hybrid split and
the gather engine (`auto_threshold_from_counts`, `dense_col_select`). The
constants are the reference's layout-selection model, kept so both
packages make the same choice for the same matrix; they are not a cost
model of this card.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "DENSE_TILE_S",
    "GATHER_SLOT_S",
    "GATHER_PAD",
    "GATHER_FLOOR_S",
    "best_tile_m",
    "dense_col_select",
    "auto_threshold",
    "auto_threshold_from_counts",
]

# cost of one scattered dense tile on the tile path, and of one nonzero on
# the gather engine (padding folded in)
DENSE_TILE_S = 100e-9
GATHER_SLOT_S = 2.5e-9
GATHER_PAD = 1.0
# reporting-only floor of the gather engine per raw nonzero
GATHER_FLOOR_S = 1.1e-9

# dense-column extraction: a column of degree d moves to the dense block
# when nrow · DENSE_COL_CELL_S < d · GATHER_SLOT_S
DENSE_COL_CELL_S = 5.0e-12
DENSE_COL_MEM_MAX = 256 * 2**20  # dense block byte budget (int8 cells)
DENSE_COL_MIN_D = 64  # fewer selected columns than this: no block
DENSE_COL_MIN_ROWS = 16384  # fewer rows than this: no block

# cost(tm) = TILE_BASE_S + tm·TILE_ROW_S per occupied (tm × tk) tile
TILE_BASE_S = 45e-9
TILE_ROW_S = 13.5e-9


def dense_col_select(coldeg, nrow: int):
    """Column ids worth moving to the dense block (ascending), or an empty
    array. ``coldeg``: per-column nonzero counts."""
    coldeg = np.asarray(coldeg)
    if nrow < DENSE_COL_MIN_ROWS:
        return np.zeros(0, np.int64)
    d_star = max(nrow * DENSE_COL_CELL_S / GATHER_SLOT_S, 8.0)
    sel = np.nonzero(coldeg >= d_star)[0]
    if sel.size < DENSE_COL_MIN_D:
        return np.zeros(0, np.int64)
    d_max = max(int(DENSE_COL_MEM_MAX // max(nrow, 1)), 0)
    if sel.size > d_max:
        order = np.argsort(-coldeg[sel], kind="stable")
        sel = sel[order[:d_max]]
    return np.sort(sel.astype(np.int64))


def best_tile_m(rows, cols, shape, tk=128, candidates=(8, 32, 128)):
    """Tile height minimizing the modeled tile-sweep cost for this
    structure: banded/blocked structure merges vertically into fewer,
    taller tiles; scattered structure stays at 8."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    n_slabs = max(-(-shape[1] // tk), 1)
    best, best_cost = candidates[0], None
    for tm in candidates:
        pair = (rows // tm) * n_slabs + cols // tk
        nt = np.unique(pair).size
        cost = nt * (TILE_BASE_S + tm * TILE_ROW_S)
        if best_cost is None or cost < best_cost:
            best, best_cost = tm, cost
    return best


def _tile_counts(rows, cols, shape, tm, tk):
    """Entries per occupied (tm × tk) tile."""
    n_slabs = max(-(-shape[1] // tk), 1)
    pair = (np.asarray(rows) // tm) * n_slabs + np.asarray(cols) // tk
    _, cnt = np.unique(pair, return_counts=True)
    return cnt


def auto_threshold_from_counts(cnt) -> tuple:
    """(threshold, cost): the occupancy cutoff minimizing the modeled cost
    when tiles with ``>= threshold`` entries take the tile path (each at
    ``DENSE_TILE_S``) and the rest the gather engine (``GATHER_SLOT_S``
    per entry). Exact, via suffix sums over the sorted counts."""
    cnt = np.sort(np.asarray(cnt, np.int64))
    if cnt.size == 0:
        return 2, 0.0
    uniq = np.unique(cnt)
    idx = np.searchsorted(cnt, uniq, side="left")
    total = cnt.sum()
    suffix_tiles = cnt.size - idx
    prefix_nnz = np.concatenate([[0], np.cumsum(cnt)])[idx]
    costs = DENSE_TILE_S * suffix_tiles + GATHER_SLOT_S * GATHER_PAD * prefix_nnz
    all_sparse = GATHER_SLOT_S * GATHER_PAD * total
    k = int(np.argmin(costs))
    if all_sparse < costs[k]:
        return int(cnt.max()) + 1, float(all_sparse)
    return max(int(uniq[k]), 2), float(costs[k])


def auto_threshold(rows, cols, shape, tm=8, tk=128) -> int:
    """Best hybrid dense/sparse occupancy threshold for this matrix."""
    return auto_threshold_from_counts(_tile_counts(rows, cols, shape, tm, tk))[0]
