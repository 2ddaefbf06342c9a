"""The least bytes and the operations of a traffic step, from the problem.

Nothing here looks at a layout the program builds, so a redesign of a
kernel can never change the yardstick, and no kernel can read less than
these bytes: a share of the byte roofline stays at or under 100 %.

* A is counted at one bit per nonzero: the 0/1 storage bound of the
  reference's ``fastsparse/bench/sol.py`` (`_ideal_a_bytes`, its
  ``ideal="bitmask"`` case, ``nnz // 8``). Its amortised row metadata
  (``nnz // 32 * 4``) is left out, because a format can do without it.
* Each operand is read once and each output written once, in float32.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense): 3.35 TB/s of
HBM3 and 1,979 TOP/s of int8 on the tensor cores, at the full 700 W.
"""
from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "INT8_OPS_PER_S", "a_bytes", "least_s",
           "op_bytes", "op_flops"]

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
F32 = 4


def a_bytes(nnz: int) -> int:
    """A 0/1 matrix at one bit per nonzero."""
    return int(nnz) // 8


def _io(op, nrow, ncol):
    """(rows of the operand read, rows of the output written)."""
    if op in ("matvec", "matmat"):
        return ncol, nrow
    if op in ("rmatvec", "rmatmat"):
        return nrow, ncol
    return ncol, ncol  # normal products and the CG solve


def op_bytes(step: dict, nnz: int, nrow: int, ncol: int, width: int) -> int:
    """Least bytes of one op of a traffic step at operand width ``width``.
    A normal product counts A once, its operand in and its output out; a
    CG solve counts ``maxiter`` normal products and none of its vector
    operations (its first product, at x0 = 0, is work a solver can skip)."""
    op = step["op"]
    r_in, r_out = _io(op, nrow, ncol)
    one = a_bytes(nnz) + F32 * width * (r_in + r_out)
    if op == "cg_normal":
        return int(step["maxiter"]) * one
    return one


def op_flops(step: dict, nnz: int, width: int) -> int:
    """2·nnz·N for a product with A or Aᵀ, twice that for a normal
    product, ``maxiter`` normal products for a CG solve (its vector
    operations left out, as in `op_bytes`)."""
    op = step["op"]
    if op in ("matvec", "matmat", "rmatvec", "rmatmat"):
        return 2 * int(nnz) * width
    if op in ("normal_matvec", "normal_matmat"):
        return 4 * int(nnz) * width
    if op == "cg_normal":
        return int(step["maxiter"]) * 4 * int(nnz) * width
    raise ValueError(f"unknown op {op!r}")


def least_s(nbytes: int, ops: int) -> float:
    """The least time of the work: bytes over the HBM rate or operations
    over the int8 tensor-core peak, the larger (the bytes, in every cell
    of this benchmark)."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S)
