"""Normal-equation products ``(AᵀA + reg·I)·x``, ``(AᵀA + reg·I)·X`` and
``(AAᵀ + reg·I)·x`` (counterpart of ``fastsparse/ops/ata.py``): two
forward products when the transpose tiling ``At`` is given, else a
forward product and the scatter engine (`spmv_t`, `spmm_t`)."""
from __future__ import annotations

from .spmm import spmm, spmm_t
from .spmv import spmv, spmv_t

__all__ = ["ata_x", "ata_X", "aat_x"]


def ata_x(A, x, At=None, reg: float = 0.0):
    """``(AᵀA + reg·I) x``."""
    tmp = spmv(A, x)
    out = spmv(At, tmp) if At is not None else spmv_t(A, tmp)
    if reg:
        out = out + reg * x
    return out


def ata_X(A, X, At=None, reg: float = 0.0):
    """``(AᵀA + reg·I) X``, the multi-RHS form."""
    tmp = spmm(A, X)
    out = spmm(At, tmp) if At is not None else spmm_t(A, tmp)
    if reg:
        out = out + reg * X
    return out


def aat_x(A, x, At=None, reg: float = 0.0):
    """``(AAᵀ + reg·I) x``."""
    tmp = spmv(At, x) if At is not None else spmv_t(A, x)
    out = spmv(A, tmp)
    if reg:
        out = out + reg * x
    return out
