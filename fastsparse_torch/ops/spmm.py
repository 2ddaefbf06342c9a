"""Multi-RHS SpMM ``Y = A @ X`` (counterpart of ``fastsparse/ops/spmm.py``).

Ported: the mono BsrMatrix branch and the f32 EllMatrix / SegmentedEll
branches (the gather engine). The reference's XLA engines (COO/CSR, the
per-bucket scan for non-f32 ELL or an X panel past its residency budget)
come with slice 4; the hybrid and column-segmented containers with slices
2b and 3. Those raise `NotImplementedError`.
"""
from __future__ import annotations

import torch

from ..formats.bsr import BsrMatrix
from ..formats.ell import EllMatrix, SegmentedEll

__all__ = ["spmm"]


def _ell_dtype(A, X):
    return torch.promote_types(A.dtype, X.dtype)


def spmm(A, X):
    """``Y = A @ X``. ``X``: f32[ncol, N] -> f32[nrow, N]."""
    if isinstance(A, BsrMatrix):
        from .bsr_ops import bsr_spmm

        return bsr_spmm(A, X)
    if isinstance(A, (EllMatrix, SegmentedEll)):
        from .ell_ops import ell_spmm, gather_engine_fits, gather_engine_supported

        fits = isinstance(A, SegmentedEll) or gather_engine_fits(
            A.shape[1], X.shape[1]
        )
        if gather_engine_supported(_ell_dtype(A, X)) and fits:
            return ell_spmm(A, X)
        raise NotImplementedError(
            "ELL products off the f32 gather engine (the reference's XLA "
            "engines: fp64 and wide unsegmented panels) are slice 4"
        )
    raise NotImplementedError(
        f"spmm over {type(A).__name__} is not ported yet (slices 2b, 3, 4)"
    )
