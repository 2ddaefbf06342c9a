"""Morton (Z-order) keys (counterpart of ``fastsparse/reorder/morton.py``),
computed with torch ops on the indices' device.

A uint32 word is held in an int64 tensor (CUDA torch has no general
uint32 sort); every key equals the reference's bit for bit. 64-bit keys
are ``(hi, lo)`` word pairs, as in the reference.
"""
from __future__ import annotations

import torch

__all__ = ["part1by1", "morton_key", "morton_key64"]

_U32 = 0xFFFFFFFF


def _u32(a) -> torch.Tensor:
    """Indices as uint32 words in an int64 tensor (an array goes to the
    CPU)."""
    return torch.as_tensor(a).to(torch.int64) & _U32


def part1by1(v) -> torch.Tensor:
    """Spread the low 16 bits of ``v`` into the even bit positions."""
    v = _u32(v) & 0x0000FFFF
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    return (v | (v << 1)) & 0x55555555


def morton_key(rows, cols) -> torch.Tensor:
    """32-bit Morton key from the low 16 bits of each coordinate."""
    return (part1by1(rows) << 1) | part1by1(cols)


def morton_key64(rows, cols):
    """64-bit Morton key as a ``(hi, lo)`` pair of uint32 words: ``hi``
    interleaves bits 16..31 of (row, col), ``lo`` bits 0..15."""
    r, c = _u32(rows), _u32(cols)
    lo = (part1by1(r) << 1) | part1by1(c)
    hi = (part1by1(r >> 16) << 1) | part1by1(c >> 16)
    return hi, lo
