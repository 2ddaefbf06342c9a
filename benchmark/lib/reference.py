"""The plain reference: the traffic's ops in plain PyTorch, from the matrix
the benchmark generated, in float64.

It imports nothing of the program and takes nothing the program made: A
comes from the generator's scipy matrix as (row, col, value) triples, and
each product is a gather of the operand's rows, a scale by the values and
an ``index_add_`` into the output, in blocks of nonzeros so that it fits
beside what a run keeps. The CG solve is the textbook iteration from
x0 = 0, with the stopping rule the program documents (``tol`` on
``‖r‖ / ‖b‖``, every column until all meet it, at most ``maxiter``); it
returns the solution, the norm of its recurred residual and the
iterations it ran, as the program's solver does.

A solve is judged by three numbers (`solve_checks`), not by its distance
to the reference's solution: after 30 iterations two float32 runs of CG
that differ only in rounding end up ~1e-3 apart in x (as far as one with
TF32 products), so x cannot tell sound from wrong.

* ``resgap``: a wrong product moves the recurred residual off the true
  residual of the x returned: ``‖b − (AᵀA + reg·I) x‖``, in float64 here,
  against the norm the solver reported, over ``‖b‖``.
* ``iters``: the iterations run against the reference solve's.
* ``resratio``: the work asked for. The true relative residual of each
  column, ``‖b − (AᵀA + reg·I) x‖ / ‖b‖``, against that of the
  reference's own solve of its own right-hand side, as ``|ln(ratio)|``.
  A float32 CG stalls above the float64 one (by up to ~4x after 30
  iterations, as rounding falls), so a sound solve reads up to ~1.5; one
  that stops early, leaves x where it started or leaves columns unsolved
  reads far more, even where it reports the iterations and residual norms
  it was asked for.

``precision="tf32"`` is the control: the same ops with every product's
operand rounded to TF32 (10 mantissa bits, to nearest even, as a TF32
tensor core rounds its inputs) and sums in float32. It is the step below
the float32 that the configurations state, and the comparison has to
call it wrong.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Reference", "Solved", "round_tf32", "rel_gap", "tensor_of"]


class Solved(NamedTuple):
    x: torch.Tensor
    resnorm: torch.Tensor  # per column
    iters: int = 0


def tensor_of(y):
    """An op's output as the next op's operand (a solver's ``x``)."""
    return y.x if isinstance(y, tuple) else y


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 mantissa bits, to nearest even."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0x0FFF + lsb) & -0x2000).view(torch.float32)


def rel_gap(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out − ref| / max |ref|, in float64; inf where out is not
    finite or has the wrong shape."""
    if tuple(out.shape) != tuple(ref.shape):
        return float("inf")
    o = out.to(torch.float64)
    if not bool(torch.isfinite(o).all()):
        return float("inf")
    den = float(ref.abs().max()) if ref.numel() else 0.0
    num = float((o - ref).abs().max()) if ref.numel() else 0.0
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


class Reference:
    """A (scipy matrix) on ``device`` as triples; ops of the traffic."""

    def __init__(self, mat, device, precision: str = "f64",
                 block: int = 1 << 21):
        if precision not in ("f64", "tf32"):
            raise ValueError(precision)
        coo = mat.tocoo()
        self.shape = tuple(coo.shape)
        self.precision = precision
        self.dtype = torch.float64 if precision == "f64" else torch.float32
        self.rows = torch.as_tensor(coo.row, device=device).long()
        self.cols = torch.as_tensor(coo.col, device=device).long()
        self.vals = torch.as_tensor(coo.data, device=device).to(self.dtype)
        self.block = int(block)

    def _operand(self, x):
        x = x.to(self.dtype)
        return round_tf32(x) if self.precision == "tf32" else x

    def _product(self, x, src, dst, n_out):
        x = self._operand(x)
        y = torch.zeros((n_out,) + tuple(x.shape[1:]), dtype=self.dtype,
                        device=x.device)
        for k in range(0, src.numel(), self.block):
            s = src[k:k + self.block]
            v = self.vals[k:k + self.block]
            part = x[s] * (v if x.ndim == 1 else v[:, None])
            y.index_add_(0, dst[k:k + self.block], part)
        return y

    def matmat(self, x):
        return self._product(x, self.cols, self.rows, self.shape[0])

    def rmatmat(self, x):
        return self._product(x, self.rows, self.cols, self.shape[1])

    matvec = matmat
    rmatvec = rmatmat

    def normal(self, x, reg=0.0):
        x = x.to(self.dtype)
        return self.rmatmat(self.matmat(x)) + reg * x

    def cg_normal(self, b, reg=0.0, tol=1e-6, maxiter=1000):
        b = b.to(self.dtype)

        def dot(u, v):
            return torch.sum(u * v, dim=0)

        x = torch.zeros_like(b)
        r = b.clone()
        p = r.clone()
        gamma = dot(r, r)
        tiny = torch.finfo(self.dtype).tiny
        tol2 = (tol * tol) * torch.clamp(dot(b, b), min=tiny)
        k = 0
        while k < maxiter and bool(torch.any(gamma > tol2)):
            q = self.normal(p, reg)
            denom = dot(p, q)
            alpha = torch.where(denom != 0, gamma / denom, 0.0)
            x = x + alpha * p
            r = r - alpha * q
            gamma_new = dot(r, r)
            beta = torch.where(gamma != 0, gamma_new / gamma, 0.0)
            p = r + beta * p
            gamma = gamma_new
            k += 1
        return Solved(x, torch.sqrt(gamma), k)

    def true_residual(self, b, x, reg):
        """Per column ``‖b − (AᵀA + reg·I) x‖`` and ``‖b‖``, in this
        reference's precision."""
        b = tensor_of(b).to(self.dtype)
        r = b - self.normal(x.to(self.dtype), reg)
        return (torch.linalg.vector_norm(r, dim=0),
                torch.linalg.vector_norm(b, dim=0))

    def solve_checks(self, b, solved, ref_b, ref_solved, reg) -> dict:
        """``resgap``, ``iters`` and ``resratio`` (see the module's
        docstring) of a solver's output ``solved`` on right-hand side
        ``b``, against the reference solve ``ref_solved`` of ``ref_b``;
        each inf for an output that is no solver result, has the wrong
        shape or is not finite."""
        bad = dict.fromkeys(("resgap", "iters", "resratio"), float("inf"))
        if not isinstance(solved, tuple) or not all(
                hasattr(solved, k) for k in ("x", "resnorm", "iters")):
            return bad
        b = tensor_of(b)
        if tuple(solved.x.shape) != tuple(b.shape):
            return bad
        if not bool(torch.isfinite(solved.x).all()):
            return bad
        true, bn = self.true_residual(b, solved.x, reg)
        said = solved.resnorm.to(self.dtype).reshape(true.shape)
        ref_true, ref_bn = self.true_residual(ref_b, ref_solved.x, reg)
        ratio = (true / bn) / (ref_true / ref_bn)
        return {
            "resgap": float(((true - said).abs() / bn).max()),
            "iters": float(abs(int(solved.iters) - int(ref_solved.iters))),
            "resratio": float(torch.log(ratio).abs().max()),
        }

    def op(self, s: dict):
        """The reference of one traffic op (see `lib.traffic`)."""
        name = s["op"]
        if name in ("matvec", "matmat", "rmatvec", "rmatmat"):
            return getattr(self, name)
        if name.startswith("normal_"):
            reg = float(s.get("reg", 0.0))
            return lambda x: self.normal(x, reg)
        if name == "cg_normal":
            return lambda b: self.cg_normal(
                b, float(s["reg"]), float(s["tol"]), int(s["maxiter"]))
        raise ValueError(f"unknown op {name!r}")
