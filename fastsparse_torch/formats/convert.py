"""Format conversions (counterpart of ``fastsparse/formats/convert.py``).

`to_csr` sorts on the matrix's device (``sort_coo(coo, "row")``: padding
to the tail, then row, then column, as the reference) and builds
``row_ptr`` as a masked bincount and cumsum. `to_csr_host`
gives the same CSR from a host lexsort; the builders use it, since format
compilation is an offline step. `transpose_coo` swaps the index arrays
and sorts row-major on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from .coo import COO, BinaryCOO
from .csr import CSR, BinaryCSR

__all__ = ["to_coo", "to_csr", "to_csr_host", "transpose_coo"]


def to_coo(mat):
    """Any port matrix -> its COO form."""
    if isinstance(mat, (COO, BinaryCOO)):
        return mat
    if hasattr(mat, "to_coo"):
        return mat.to_coo()
    raise NotImplementedError(
        f"to_coo: {type(mat).__name__} has no COO form in the port"
    )


def _csr_like(coo, row_ptr, rows, cols, vals):
    if isinstance(coo, BinaryCOO):
        return BinaryCSR(row_ptr=row_ptr, cols=cols, rows=rows,
                         shape=coo.shape, n_valid=coo.n_valid)
    return CSR(row_ptr=row_ptr, cols=cols, vals=vals, rows=rows,
               shape=coo.shape, n_valid=coo.n_valid)


def to_csr(coo):
    """COO -> CSR (valued or binary) on the COO's device."""
    from ..reorder.sort import sort_coo

    nrow = coo.shape[0]
    s = sort_coo(coo, "row")
    counts = torch.zeros(nrow, dtype=torch.int64, device=s.rows.device)
    counts.index_add_(0, s.rows.long(), s.valid_mask().long())
    row_ptr = torch.zeros(nrow + 1, dtype=torch.int32, device=s.rows.device)
    row_ptr[1:] = torch.cumsum(counts, 0).to(torch.int32)
    return _csr_like(coo, row_ptr, s.rows, s.cols, getattr(s, "vals", None))


def to_csr_host(coo):
    """COO -> CSR through a host lexsort; tensors land on the COO's
    device, padding entries (zeros) at the tail."""
    dev = coo.rows.device
    n = coo.n_valid
    rows = coo.rows[:n].cpu().numpy()
    cols = coo.cols[:n].cpu().numpy()
    order = np.lexsort((cols, rows))
    row_ptr = np.zeros(coo.shape[0] + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=coo.shape[0]), out=row_ptr[1:])
    pad = coo.nnz_cap - n

    def t(a):
        a = torch.as_tensor(a, device=dev)
        if pad:
            a = torch.cat([a, torch.zeros(pad, dtype=a.dtype, device=dev)])
        return a

    vals = None
    if not isinstance(coo, BinaryCOO):
        vals = t(coo.vals[:n].cpu().numpy()[order])
    return _csr_like(
        coo, torch.as_tensor(row_ptr, device=dev),
        t(rows[order].astype(np.int32)), t(cols[order].astype(np.int32)),
        vals,
    )


def transpose_coo(coo):
    """Transpose by swapping the index arrays, entries re-sorted row-major
    (`reorder.sort.sort_coo`), padding last."""
    import dataclasses

    from ..reorder.sort import sort_coo

    t = dataclasses.replace(coo, rows=coo.cols, cols=coo.rows,
                            shape=(coo.shape[1], coo.shape[0]))
    return sort_coo(t, "row")
