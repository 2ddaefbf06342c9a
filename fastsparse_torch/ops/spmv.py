"""SpMV ``y = A @ x`` (counterpart of ``fastsparse/ops/spmv.py``).

Ported: the mono BsrMatrix branch and the f32 EllMatrix / SegmentedEll
branches. The reference runs ELL SpMV through the gather SpMM kernel on
its accelerator (one gathered row per nonzero costs the same at N=1);
the port takes that dispatch on every device: the CUDA kernels on a CUDA
tensor, their plain versions on a CPU tensor. The other engines raise
`NotImplementedError` (slices 2b, 3, 4).
"""
from __future__ import annotations

from ..formats.bsr import BsrMatrix
from ..formats.ell import EllMatrix, SegmentedEll

__all__ = ["spmv"]


def spmv(A, x):
    """``y = A @ x``. ``x``: f32[ncol] -> f32[nrow]."""
    if isinstance(A, BsrMatrix):
        from .bsr_ops import bsr_spmv

        return bsr_spmv(A, x)
    if isinstance(A, (EllMatrix, SegmentedEll)):
        from .ell_ops import ell_spmm, gather_engine_fits, gather_engine_supported
        from .spmm import _ell_dtype

        seg_ncol = A.seg_cols if isinstance(A, SegmentedEll) else A.shape[1]
        if gather_engine_supported(_ell_dtype(A, x)) and gather_engine_fits(
            seg_ncol, 1
        ):
            return ell_spmm(A, x[:, None])[:, 0]
        raise NotImplementedError(
            "ELL SpMV off the f32 gather engine (the reference's XLA "
            "engines) is slice 4"
        )
    raise NotImplementedError(
        f"spmv over {type(A).__name__} is not ported yet (slices 2b, 3, 4)"
    )
