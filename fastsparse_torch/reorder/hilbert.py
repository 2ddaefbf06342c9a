"""Hilbert-curve keys (counterpart of ``hilbert_key64`` in
``fastsparse/reorder/hilbert.py``), computed with numpy on the host.

The quadrant-rotation recurrence of the classic ``xy2d`` runs as a
vectorized bit sweep over whole index arrays, most significant digit
first, exactly as the reference's: the keys, and so the orderings built
from them, are the reference's.
"""
from __future__ import annotations

import numpy as np

__all__ = ["hilbert_key64"]


def hilbert_key64(rows, cols, order: int = 32):
    """64-bit Hilbert key of each (row, col) as a ``(hi, lo)`` uint32 pair
    (``order`` <= 32 coordinate bits per axis)."""
    if order > 32:
        raise ValueError("order > 32 unsupported")
    x = np.asarray(cols).astype(np.uint32)
    y = np.asarray(rows).astype(np.uint32)
    key = np.zeros(x.shape, np.uint64)
    one = np.uint32(1)
    for i in range(order - 1, -1, -1):
        s = np.uint32(i)
        rx = (x >> s) & one
        ry = (y >> s) & one
        q = (np.uint32(3) * rx) ^ ry
        key = (key << np.uint64(2)) | q.astype(np.uint64)
        # rotate the low i bits into the subquadrant's frame (the ry == 0
        # branch of xy2d, as selects)
        low = np.uint32((1 << i) - 1)
        xl, yl = x & low, y & low
        flip = (ry == 0) & (rx == 1)
        xf = np.where(flip, low - xl, xl)
        yf = np.where(flip, low - yl, yl)
        swap = ry == 0
        x, y = np.where(swap, yf, xf), np.where(swap, xf, yf)
    return ((key >> np.uint64(32)).astype(np.uint32),
            (key & np.uint64(0xFFFFFFFF)).astype(np.uint32))
