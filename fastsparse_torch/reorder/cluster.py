"""Row and column permutations for tile density (counterpart of
``fastsparse/reorder/cluster.py``).

Every ordering is computed on the host with the reference's numpy code,
so the permutations equal the reference's; they come back as int32
tensors on the matrix's device. `permute_coo` relabels the entries and
`linops.SparseOperator` permutes operands at its boundary with the
inverses (`invert_perm`). The reference's jitted device version of
`degree_perms` serves traced inputs only and has no counterpart here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..bench import model as _model
from ..formats.coo import BinaryCOO
from .hilbert import hilbert_key64

__all__ = [
    "degree_perms",
    "minhash_perms",
    "tilepack_perms",
    "hilbert_perms",
    "best_perms",
    "invert_perm",
    "permute_coo",
]


def _entries(coo):
    n = coo.n_valid
    return coo.rows[:n].cpu().numpy(), coo.cols[:n].cpu().numpy()


def _perm_tensors(coo, rp, cp):
    dev = coo.rows.device
    return (torch.as_tensor(np.asarray(rp).astype(np.int32), device=dev),
            torch.as_tensor(np.asarray(cp).astype(np.int32), device=dev))


def invert_perm(perm: torch.Tensor) -> torch.Tensor:
    """inv with inv[perm[k]] = k."""
    inv = torch.empty_like(perm)
    inv[perm.long()] = torch.arange(perm.shape[0], dtype=perm.dtype,
                                    device=perm.device)
    return inv


def _degree_host(rows, cols, shape):
    rdeg = np.bincount(rows, minlength=shape[0])
    cdeg = np.bincount(cols, minlength=shape[1])
    return (np.argsort(-rdeg, kind="stable").astype(np.int32),
            np.argsort(-cdeg, kind="stable").astype(np.int32))


def degree_perms(coo):
    """(row_perm, col_perm): old index of the k-th densest row/column, in
    stable descending-degree order."""
    rows, cols = _entries(coo)
    return _perm_tensors(coo, *_degree_host(rows, cols, coo.shape))


def _mix(x, salt):
    x = (x.astype(np.uint64) + np.uint64(salt)) * np.uint64(
        0x9E3779B97F4A7C15
    )
    x ^= x >> np.uint64(29)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(32)
    return x


def _minhash_host(rows, cols, shape, iters=2, seed=0):
    nrow, ncol = shape
    U64 = np.uint64(0xFFFFFFFFFFFFFFFF)
    rp = np.arange(nrow)
    cp = np.arange(ncol)
    for it in range(iters):
        h1 = _mix(cols, seed + 101 + it)
        h2 = _mix(cols, seed + 202 + it)
        s1 = np.full(nrow, U64)
        s2 = np.full(nrow, U64)
        np.minimum.at(s1, rows, h1)
        np.minimum.at(s2, rows, h2)
        rp = np.lexsort((s2, s1))
        rinv = np.empty(nrow, np.int64)
        rinv[rp] = np.arange(nrow)
        sc = np.full(ncol, np.int64(nrow))
        np.minimum.at(sc, cols, rinv[rows])
        cp = np.argsort(sc, kind="stable")
    return rp, cp


def minhash_perms(coo, iters: int = 2, seed: int = 0):
    """Similarity co-clustering: rows ordered by a 2-hash MinHash of their
    column sets, columns by their least relabeled row, alternated."""
    rows, cols = _entries(coo)
    return _perm_tensors(coo, *_minhash_host(rows, cols, coo.shape, iters,
                                             seed))


def _colpack(rows, cols, ncol, new_rows, group_rows, min_freq):
    """Column order from greedy per-row-group packing: each group of
    ``group_rows`` permuted rows appends its frequent unplaced columns (>=
    ``min_freq`` uses, most used first); the rest follow by degree."""
    g = new_rows // group_rows
    order = np.lexsort((cols, g))
    gs, cs = g[order], cols[order]
    key = gs * np.int64(ncol) + cs
    bnd = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    freq = np.diff(np.r_[bnd, key.size])
    ug, uc = gs[bnd], cs[bnd]
    keep = freq >= min_freq
    oo = np.lexsort((-freq[keep], ug[keep]))
    cand = uc[keep][oo]
    if cand.size:
        _, first = np.unique(cand, return_index=True)
        head = cand[np.sort(first)]
    else:
        head = np.empty(0, np.int64)
    placed = np.zeros(ncol, bool)
    placed[head] = True
    rest = np.flatnonzero(~placed)
    cdeg = np.bincount(cols, minlength=ncol)
    rest = rest[np.argsort(-cdeg[rest], kind="stable")]
    return np.concatenate([head, rest])


def _slab_regroup(rows, cols, nrow, ncol, cinv, tk):
    """Row order aligning rows to the packed column slabs: sorted by
    (dominant tk-slab, its count descending, second slab)."""
    slab = cinv[cols] // tk
    nsl = max(-(-ncol // tk), 1)
    key = rows * np.int64(nsl) + slab
    order = np.argsort(key, kind="stable")
    ks = key[order]
    bnd = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    cnt = np.diff(np.r_[bnd, ks.size])
    urow, uslab = ks[bnd] // nsl, ks[bnd] % nsl
    oo = np.lexsort((-cnt, urow))
    ur, us, uct = urow[oo], uslab[oo], cnt[oo]
    firsts = np.flatnonzero(np.r_[True, ur[1:] != ur[:-1]])
    s1 = np.full(nrow, nsl, np.int64)
    c1 = np.zeros(nrow, np.int64)
    s2 = np.full(nrow, nsl, np.int64)
    s1[ur[firsts]] = us[firsts]
    c1[ur[firsts]] = uct[firsts]
    sec = firsts + 1
    sec = sec[sec < ur.size]
    sec = sec[ur[sec] == ur[sec - 1]]
    s2[ur[sec]] = us[sec]
    return np.lexsort((s2, -c1, s1))


def _tilepack_host(rows, cols, shape, base="minhash", rounds=2,
                   group_rows=32, min_freq=6, tk=128, seed=0):
    nrow, ncol = shape
    rows = rows.astype(np.int64)
    cols = cols.astype(np.int64)
    if rows.size == 0:
        return np.arange(nrow), np.arange(ncol)
    if base == "degree":
        rp = _degree_host(rows, cols, shape)[0].astype(np.int64)
    else:
        rp = _minhash_host(rows, cols, shape, seed=seed)[0].astype(np.int64)
    cp = np.arange(ncol, dtype=np.int64)
    for _ in range(rounds):
        rinv = np.empty(nrow, np.int64)
        rinv[rp] = np.arange(nrow)
        cp = _colpack(rows, cols, ncol, rinv[rows], group_rows, min_freq)
        cinv = np.empty(ncol, np.int64)
        cinv[cp] = np.arange(ncol)
        rp = _slab_regroup(rows, cols, nrow, ncol, cinv, tk)
    return rp, cp


def tilepack_perms(coo, base: str = "minhash", rounds: int = 2,
                   group_rows: int = 32, min_freq: int = 6, tm: int = 8,
                   tk: int = 128, seed: int = 0):
    """Tile-density mining: similarity row clustering, greedy column
    packing and slab-aligned row regrouping, iterated ``rounds`` times.
    ``base`` seeds the row order ("minhash" or "degree")."""
    rows, cols = _entries(coo)
    return _perm_tensors(coo, *_tilepack_host(
        rows, cols, coo.shape, base, rounds, group_rows, min_freq, tk, seed))


def _hilbert_host(rows, cols, shape):
    nrow, ncol = shape
    hi, lo = (k.numpy().astype(np.uint64) for k in hilbert_key64(rows, cols))
    key = (hi << np.uint64(32)) | lo
    order = np.argsort(key, kind="stable")

    def first_appear(stream, n):
        vals, first = np.unique(stream, return_index=True)
        head = vals[np.argsort(first, kind="stable")]
        missing = np.setdiff1d(np.arange(n, dtype=np.int64), vals)
        return np.concatenate([head, missing])

    return first_appear(rows[order], nrow), first_appear(cols[order], ncol)


def hilbert_perms(coo):
    """Rows and columns renumbered by first appearance along the Hilbert
    curve over the entries."""
    rows, cols = _entries(coo)
    return _perm_tensors(coo, *_hilbert_host(rows, cols, coo.shape))


def _ordering_cost(rows, cols, shape, rinv, cinv, tm=8, tk=128):
    """Modeled seconds per product under the hybrid split at its best
    threshold (`bench.model`)."""
    r2 = rinv[rows] if rinv is not None else rows
    c2 = cinv[cols] if cinv is not None else cols
    nsl = max(-(-shape[1] // tk), 1)
    pair = (r2 // tm) * nsl + c2 // tk
    _, cnt = np.unique(pair, return_counts=True)
    return _model.auto_threshold_from_counts(cnt)[1]


def best_perms(coo):
    """The ordering (identity, degree, minhash, tilepack from minhash or
    degree, hilbert) minimizing the modeled product cost: (row_perm,
    col_perm), or (None, None) for the identity."""
    rows, cols = _entries(coo)
    shape = coo.shape
    cands = {
        "none": (None, None),
        "degree": _degree_host(rows, cols, shape),
        "minhash": _minhash_host(rows, cols, shape),
        "tilepack": _tilepack_host(rows, cols, shape, base="minhash"),
        "tilepack-deg": _tilepack_host(rows, cols, shape, base="degree"),
        "hilbert": _hilbert_host(rows, cols, shape),
    }
    best, best_cost = "none", None
    for name, (r, c) in cands.items():
        rinv = cinv = None
        if r is not None:
            rinv = np.empty(r.size, np.int64)
            rinv[r] = np.arange(r.size)
            cinv = np.empty(c.size, np.int64)
            cinv[c] = np.arange(c.size)
        cost = _ordering_cost(rows, cols, shape, rinv, cinv)
        if best_cost is None or cost < best_cost:
            best, best_cost = name, cost
    if best == "none":
        return None, None
    return _perm_tensors(coo, *cands[best])


def permute_coo(coo, row_perm, col_perm):
    """Relabel entries: new_row = rinv[row], new_col = cinv[col]. The result
    represents ``P_r A P_cᵀ``: ``(P_r A P_cᵀ) @ x[col_perm] == (A @
    x)[row_perm]``."""
    rinv = invert_perm(row_perm)
    cinv = invert_perm(col_perm)
    rows = rinv[coo.rows.long()]
    cols = cinv[coo.cols.long()]
    if not isinstance(coo, BinaryCOO):
        valid = coo.valid_mask()
        rows = torch.where(valid, rows, 0)
        cols = torch.where(valid, cols, 0)
    return dataclasses.replace(coo, rows=rows, cols=cols, row_sorted=False)
