"""The one traffic generator: a mix's data file in, a step to time out.

A mix (``benchmark/traffic/<mix>.json``) is parameters only::

    {"operand": {"of": "cols", "width": 128, "buffers": 4},
     "step": [{"op": "matmat"}],
     "unit": "call"}

* ``operand``: the step's input, drawn from the seed on the device: rows of
  ``of`` ("cols": A's column count, the operand of ``A·X``; "rows": its
  row count, the operand of ``Aᵀ·X``), ``width`` columns (width 1 with
  ``"vector": true`` is a vector), ``buffers`` distinct operands the
  steps rotate over (a sampler's operand is new every step, and together
  they outgrow the L2).
* ``step``: the port's public entry points, applied in order, each to the
  previous op's output. ``op`` is a `SparseOperator` method (``matvec``,
  ``matmat``, ``rmatvec``, ``rmatmat``, ``normal_matvec``,
  ``normal_matmat``, with ``reg``) or ``cg_normal`` (with ``reg``,
  ``tol``, ``maxiter``; its output is the solver's result, the solution
  ``x``, the residual norm ``resnorm`` and the iterations ``iters`` it
  reports).
* ``unit``: what one step is to the end-to-end metrics ("call": one
  product of one caller; "step": one sampler step).

One caller runs in a closed loop: a step, then ``torch.cuda.synchronize()``,
then the next, as a Gibbs sampler waits on each product.
"""
from __future__ import annotations

from .reference import tensor_of

__all__ = ["OPS", "needs_transpose", "operand_shape", "make_step"]

OPS = ("matvec", "matmat", "rmatvec", "rmatmat", "normal_matvec",
       "normal_matmat", "cg_normal")
_TRANSPOSED = ("rmatvec", "rmatmat", "normal_matvec", "normal_matmat",
               "cg_normal")


def needs_transpose(traffic: dict) -> bool:
    """Whether the step uses the transpose tiling (``operator(...,
    transpose=True)``); a cell builds only the tilings it uses."""
    return any(s["op"] in _TRANSPOSED for s in traffic["step"])


def operand_shape(traffic: dict, shape) -> tuple:
    o = traffic["operand"]
    rows = shape[1] if o["of"] == "cols" else shape[0]
    if o.get("vector"):
        if int(o["width"]) != 1:
            raise ValueError("a vector operand has width 1")
        return (rows,)
    return (rows, int(o["width"]))


def _call(ft, op, s: dict, first: bool):
    name = s["op"]
    if name not in OPS:
        raise ValueError(f"unknown op {name!r}")
    if name == "cg_normal":
        reg, tol, maxiter = float(s["reg"]), float(s["tol"]), int(s["maxiter"])
        return lambda b: ft.cg_normal(op, tensor_of(b), reg=reg, tol=tol,
                                      maxiter=maxiter)
    fn = getattr(op, name)
    if name.startswith("normal_"):
        reg = float(s.get("reg", 0.0))
        return lambda x: fn(tensor_of(x), reg=reg)
    return fn if first else (lambda x: fn(tensor_of(x)))


def make_step(ft, op, traffic: dict):
    """The step's ops as callables on the program's operator ``op``;
    each takes the previous op's output."""
    return [_call(ft, op, s, k == 0) for k, s in enumerate(traffic["step"])]
