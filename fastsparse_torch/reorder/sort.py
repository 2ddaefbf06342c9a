"""Co-sorting of sparse-matrix entries on their device (counterpart of
``fastsparse/reorder/sort.py``).

The reference sorts with one lexicographic ``lax.sort``; here the same
stable sort is a chain of stable ``torch.sort`` passes, least significant
key first, each reordering a running permutation. 64-bit orderings are
``(hi, lo)`` uint32 word pairs held in int64 tensors. Padding entries
(``k >= n_valid``) always sort to the tail: a validity key goes first.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..formats.coo import BinaryCOO
from .hilbert import hilbert_key64
from .morton import _u32, morton_key64

__all__ = ["cosort", "sort_coo", "ORDERINGS"]

ORDERINGS = ("hilbert", "morton", "row", "col")


def cosort(keys: Sequence[torch.Tensor], payloads: Sequence[torch.Tensor]):
    """Stable lexicographic sort by ``keys`` (most significant first);
    returns co-sorted ``payloads``."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in reversed(keys):
        order = order[torch.sort(key[order], stable=True).indices]
    return tuple(p[order] for p in payloads)


def _keys_for(order: str, rows, cols):
    if order == "hilbert":
        return list(hilbert_key64(rows, cols))
    if order == "morton":
        return list(morton_key64(rows, cols))
    if order == "row":  # row-major: the order CSR conversion wants
        return [_u32(rows), _u32(cols)]
    if order == "col":  # column-major
        return [_u32(cols), _u32(rows)]
    raise ValueError(f"unknown ordering {order!r}")


def sort_coo(coo, order: str = "hilbert"):
    """``coo`` with its entries reordered on its device, padding last
    (the reference's ``sort_coo``; the result is not marked
    ``row_sorted``, as there)."""
    invalid = (~coo.valid_mask()).to(torch.int64)
    keys = [invalid] + _keys_for(order, coo.rows, coo.cols)
    if isinstance(coo, BinaryCOO):
        rows, cols = cosort(keys, (coo.rows, coo.cols))
        return dataclasses.replace(coo, rows=rows, cols=cols,
                                   row_sorted=False)
    rows, cols, vals = cosort(keys, (coo.rows, coo.cols, coo.vals))
    return dataclasses.replace(coo, rows=rows, cols=cols, vals=vals,
                               row_sorted=False)
