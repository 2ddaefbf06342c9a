"""The least bytes of a traffic step over a valued (f32) matrix, from the
problem, for the share of the byte roofline of a cell whose matrix has
values (`lib.roofline` counts A at one bit per nonzero, the 0/1 bound).

* A is counted at 4 bytes per stored nonzero: its float32 value. Its
  column ids are left out: a layout may narrow them (the segmented ELL
  holds them segment-local), so no format is held to bytes it can save.
* Each operand is read once and each output written once, in float32, as
  in `lib.roofline`.

Nothing here looks at a layout the program builds, so the share stays at
or under 100 % whatever the format.
"""
from __future__ import annotations

from . import roofline

__all__ = ["VALUE_BYTES", "op_bytes", "least_s"]

VALUE_BYTES = 4  # one float32 value per stored nonzero


def op_bytes(step: dict, nnz: int, nrow: int, ncol: int, width: int) -> int:
    """Least bytes of one op of a traffic step at operand width ``width``:
    `lib.roofline.op_bytes`'s operand and output, with A's values read
    once per product (``maxiter`` times for a CG solve)."""
    io = roofline.op_bytes(step, 0, nrow, ncol, width)
    passes = int(step["maxiter"]) if step["op"] == "cg_normal" else 1
    return io + passes * VALUE_BYTES * int(nnz)


def least_s(traffic: dict, nnz: int, nrow: int, ncol: int) -> float:
    """The least time of one traffic step: its bytes at the HBM rate, or
    its operations at the int8 peak, the larger (`lib.roofline.least_s`)."""
    width = int(traffic["operand"]["width"])
    nbytes = sum(op_bytes(s, nnz, nrow, ncol, width) for s in traffic["step"])
    flops = sum(roofline.op_flops(s, nnz, width) for s in traffic["step"])
    return roofline.least_s(nbytes, flops)
