"""The least bytes of a traffic step over a float64 matrix, and the device
time of the program's f64 gather kernel, for the share of the byte
roofline that kernel reaches (`lib.roofline` counts A at one bit per
nonzero, the 0/1 bound; `lib.roofline_valued` at a float32 value).

* A is counted at 8 bytes per stored nonzero: its float64 value. Its
  column ids are left out, as in `lib.roofline_valued`: a layout may
  narrow them.
* Each operand is read once and each output written once, in float64:
  the product's precision, whatever dtype the operand arrives in.

Nothing here looks at a layout the program builds. The kernel's time is
read from the traced sessions' device operations (`lib.trace`) by name:
the program's table kernel in its f64 mode, ``ell_table_kernel<double,
...>`` (``ell_table_kernelId`` where the name comes mangled). A program
without that mode has no such record, and the share reads nothing.
"""
from __future__ import annotations

from . import roofline

__all__ = ["VALUE_BYTES", "F64", "op_bytes", "least_s", "kernel_s"]

VALUE_BYTES = 8  # one float64 value per stored nonzero
F64 = 8  # an operand or output element
KERNEL = "ell_table_kernel"
F64_MARKS = ("<double", "ell_table_kernelId")


def op_bytes(step: dict, nnz: int, nrow: int, ncol: int, width: int) -> int:
    """Least bytes of one op of a traffic step at operand width ``width``:
    A's values read once per product (``maxiter`` normal products for a
    CG solve, as `lib.roofline.op_bytes` counts them), the operand read
    and the output written once in float64."""
    op = step["op"]
    r_in, r_out = roofline._io(op, nrow, ncol)
    if op.startswith("normal_") or op == "cg_normal":
        a = 2 * VALUE_BYTES * int(nnz)  # A, then Aᵀ
    else:
        a = VALUE_BYTES * int(nnz)
    one = a + F64 * width * (r_in + r_out)
    return int(step["maxiter"]) * one if op == "cg_normal" else one


def least_s(traffic: dict, nnz: int, nrow: int, ncol: int) -> float:
    """The least time of one traffic step: its bytes at the HBM rate."""
    width = int(traffic["operand"]["width"])
    nbytes = sum(op_bytes(s, nnz, nrow, ncol, width) for s in traffic["step"])
    return nbytes / roofline.HBM_BYTES_PER_S


def kernel_s(traced) -> float | None:
    """Device seconds of the f64 table kernel over the kept sessions, from
    their device operations by name; None where none was recorded."""
    if not traced:
        return None
    got = [s for name, s in traced.get("device_ops", ())
           if KERNEL in name and any(k in name for k in F64_MARKS)]
    return sum(got) if got else None
