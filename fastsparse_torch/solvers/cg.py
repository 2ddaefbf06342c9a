"""Conjugate-gradient solvers for sparse normal equations (counterpart of
``fastsparse/solvers/cg.py``).

Macau/SMURFF's Gibbs sampler solves ``(AᵀA + reg·I) v = b`` by CG every
iteration; `cg_normal` runs that solve over a `SparseOperator`, one RHS
or a block of independent RHS columns. The reference's
``lax.while_loop`` is a Python loop here: the stopping test reads the
residual on the host once per iteration (span ``cg.sync``, the solve's one
host wait on the device).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import tracing

__all__ = ["cg", "cg_normal", "normal_jacobi", "CGResult"]


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int  # iterations executed
    resnorm: torch.Tensor  # final ‖r‖ per RHS


def _any_above(res, tol2) -> bool:
    """Whether a column's squared residual is above its tolerance: the
    loop's read-back, where the host waits for the device."""
    with tracing.span("cg.sync"):
        tracing.count(3)  # the compare, the reduction and the copy back
        tracing.count(1, "syncs")
        return bool(torch.any(res > tol2))


def _cg_impl(matvec, b, x0, tol, maxiter, minv=None):
    # b of shape (n,) or (n, k): all math is columnwise
    def dot(u, v):
        return torch.sum(u * v, dim=0)

    def prec(r):
        return r if minv is None else minv(r)

    # device ops of the set-up and of an iteration, matvec excluded: a dot
    # is two, a `where` of a ratio four (its scalar is filled on the
    # device), the preconditioner one
    pre = minv is not None
    with tracing.span("cg.solve"):
        tracing.count(12 + pre + (x0 is None))
        if x0 is None:
            x0 = torch.zeros_like(b)
        x = x0
        r = b - matvec(x0)
        z = prec(r)
        p = z
        gamma = dot(r, z)
        res = dot(r, r)
        bnorm2 = torch.clamp(dot(b, b), min=torch.finfo(b.dtype).tiny)
        tol = torch.full((), tol, dtype=b.dtype, device=b.device)
        tol2 = (tol * tol) * bnorm2
        k = 0
        while k < maxiter and _any_above(res, tol2):
            with tracing.span("cg.iter"):
                tracing.count(20 + pre)
                q = matvec(p)
                denom = dot(p, q)
                alpha = torch.where(denom != 0, gamma / denom, 0.0)
                x = x + alpha * p
                r = r - alpha * q
                z = prec(r)
                gamma_new = dot(r, z)
                beta = torch.where(gamma != 0, gamma_new / gamma, 0.0)
                p = z + beta * p
                gamma = gamma_new
                res = dot(r, r)
            k += 1
        return CGResult(x=x, iters=k, resnorm=torch.sqrt(res))


def cg(matvec: Callable, b, x0=None, *, tol: float = 1e-6,
       maxiter: int = 1000) -> CGResult:
    """Solve ``M x = b`` for SPD ``M`` given ``matvec``; b: (n,) or (n, k)."""
    return _cg_impl(matvec, b, x0, tol, maxiter)


def normal_jacobi(mat, reg: float = 0.0, device="cuda"):
    """Inverse Jacobi diagonal of ``AᵀA + reg·I``: ``1 / (Σ_i A_ij² + reg)``,
    from a scipy matrix or a port COO; pass it as ``cg_normal(...,
    precond=...)``."""
    if hasattr(mat, "tocoo") and not hasattr(mat, "rows"):
        m = mat.tocoo()
        cols, vals, ncol = m.col, m.data, m.shape[1]
    else:
        from ..formats.convert import to_coo

        coo = to_coo(mat)
        cols = coo.cols[: coo.n_valid].cpu().numpy()
        ncol = coo.shape[1]
        if hasattr(coo, "vals"):
            vals = coo.vals[: coo.n_valid].cpu().numpy()
        else:
            vals = np.ones(cols.shape[0], np.float32)
    d = np.zeros(ncol, np.float64)
    np.add.at(d, cols, np.asarray(vals, np.float64) ** 2)
    d = d + reg
    d[d == 0] = 1.0
    out_dt = np.result_type(vals.dtype, np.float32)
    return torch.as_tensor((1.0 / d).astype(out_dt), device=device)


def cg_normal(op, b, reg: float = 0.0, x0=None, *, tol: float = 1e-6,
              maxiter: int = 1000, precond=None) -> CGResult:
    """Solve ``(AᵀA + reg·I) x = b`` over a `SparseOperator` (multi-RHS
    when b is (ncol, k)). ``precond``: optional inverse-diagonal vector
    (`normal_jacobi`) for Jacobi-preconditioned CG."""
    if b.ndim == 1:
        def matvec(v):
            return op.normal_matvec(v, reg=reg)
    else:
        def matvec(v):
            return op.normal_matmat(v, reg=reg)
    minv = None
    if precond is not None:
        dinv = torch.as_tensor(precond, dtype=b.dtype, device=b.device)
        if b.ndim > 1:
            dinv = dinv[:, None]

        def minv(r):
            return dinv * r
    return _cg_impl(matvec, b, x0, tol, maxiter, minv)
