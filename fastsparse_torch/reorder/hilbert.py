"""Hilbert-curve keys (counterpart of ``fastsparse/reorder/hilbert.py``).

The quadrant-rotation recurrence of the classic ``xy2d`` runs as a
vectorized bit sweep over whole index arrays, most significant digit
first, exactly as the reference's: the keys, and so the orderings built
from them, are the reference's. It runs on the indices' device (uint32
words held in int64 tensors; an array runs on the CPU), for
`reorder.sort.sort_coo` on the card and for the host renumbering of
``reorder="hilbert"``. ``hilbert_d2xy`` is the inverse.
"""
from __future__ import annotations

import torch

from .morton import _u32

__all__ = ["hilbert_key", "hilbert_key64", "hilbert_d2xy"]


def _hilbert_digits(rows, cols, order: int):
    """The 2-bit quadrant digits, most significant first: at bit ``i`` the
    digit is ``(3·rx) XOR ry``, then the low ``i`` bits of (x, y) are
    rotated into that quadrant's frame (the ry == 0 branch of xy2d)."""
    x, y = _u32(cols), _u32(rows)
    digits = []
    for i in range(order - 1, -1, -1):
        rx = (x >> i) & 1
        ry = (y >> i) & 1
        digits.append((3 * rx) ^ ry)
        low = (1 << i) - 1
        xl, yl = x & low, y & low
        flip = (ry == 0) & (rx == 1)
        xf = torch.where(flip, low - xl, xl)
        yf = torch.where(flip, low - yl, yl)
        swap = ry == 0
        x, y = torch.where(swap, yf, xf), torch.where(swap, xf, yf)
    return digits


def hilbert_key(rows, cols, order: int = 16) -> torch.Tensor:
    """32-bit Hilbert key (``order`` <= 16 coordinate bits per axis)."""
    if order > 16:
        raise ValueError("order > 16 needs hilbert_key64")
    d = torch.zeros_like(_u32(rows))
    for q in _hilbert_digits(rows, cols, order):
        d = (d << 2) | q
    return d


def hilbert_key64(rows, cols, order: int = 32):
    """64-bit Hilbert key of each (row, col) as a ``(hi, lo)`` pair of
    uint32 words (``order`` <= 32 coordinate bits per axis)."""
    if order > 32:
        raise ValueError("order > 32 unsupported")
    hi = torch.zeros_like(_u32(rows))
    lo = torch.zeros_like(hi)
    for q in _hilbert_digits(rows, cols, order):
        hi = (hi << 2) | (lo >> 30)
        lo = ((lo << 2) | q) & 0xFFFFFFFF
    return hi, lo


def hilbert_d2xy(d, order: int = 16):
    """Inverse map: 32-bit Hilbert index -> ``(rows, cols)``, the bottom-up
    sweep of the same rotation recurrence."""
    t = _u32(d)
    x = torch.zeros_like(t)
    y = torch.zeros_like(t)
    for i in range(order):
        rx = (t >> 1) & 1
        ry = (t ^ rx) & 1
        low = (1 << i) - 1
        xl, yl = x & low, y & low
        flip = (ry == 0) & (rx == 1)
        xs = torch.where(flip, low - xl, xl)
        ys = torch.where(flip, low - yl, yl)
        swap = ry == 0
        x, y = torch.where(swap, ys, xs), torch.where(swap, xs, ys)
        x = x | (rx << i)
        y = y | (ry << i)
        t = t >> 2
    return y, x
