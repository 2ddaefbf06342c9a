"""The assembly-plan kernel: CUDA wrapper.

`plan_sum` applies an assembly plan (`ops.assemble`) in one launch of the
hand-written sm_90a kernel in ``csrc/assemble.cu``: output row r is the
sum, in order, of the parts' rows ``src[row_ptr[r]:row_ptr[r+1]]`` (the
plan's row-ordered schedule, `ops.assemble.plan_schedule`), each row
written once. It replaces no Pallas kernel: the reference leaves the plan
to XLA as row gathers and adds. Its plain versions are those torch ops,
which stay the CPU path and the on-card oracle: `ops.assemble.sum_plan`
runs this kernel on a CUDA operand and them elsewhere.
"""
from __future__ import annotations

import torch

from ... import tracing
from .bsr_spmm import _check, _launch, _library_for, _ptr

__all__ = ["launches", "reset_launches", "plan_sum"]

# kernel launches (CUDA path only)
launches = {"plan_sum": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def plan_sum(row_ptr, src, parts, n_levels: int = 0):
    """``(len(row_ptr) - 1, parts.shape[1])`` of ``parts``' dtype: row r
    is ``parts[src[row_ptr[r]]] + parts[src[row_ptr[r] + 1]] + ...``, one
    add at a time in that order; a row with no source is +0.0, and a row
    of 1..n_levels-1 sources gets a last ``+ 0.0`` (a ``row_srcs`` plan's
    sentinel levels). Bit-equal to the torch ops it replaces.

    ``row_ptr``, ``src`` int32 on ``parts``' device; ``parts`` f32 (or
    f64: a float64 product's segment parts) ``(n, L)`` on a CUDA device
    (`ops.assemble.sum_plan` runs the plan's torch ops on the CPU)."""
    dev = parts.device
    _check("plan_sum.parts", parts,
           torch.float64 if parts.dtype == torch.float64 else torch.float32,
           2)
    _check("plan_sum.row_ptr", row_ptr, torch.int32, 1, dev)
    _check("plan_sum.src", src, torch.int32, 1, dev)
    if not parts.is_cuda:
        raise ValueError("plan_sum: a CUDA kernel; the CPU runs the plan's "
                         "torch ops")
    lib = _library_for(parts)
    out = torch.empty((row_ptr.numel() - 1, parts.shape[1]),
                      dtype=parts.dtype, device=dev)
    _launch(
        "plan_sum", lib.fs_plan_sum, _ptr(row_ptr), _ptr(src), _ptr(parts),
        _ptr(out), out.shape[0], out.shape[1], int(n_levels),
        int(parts.dtype == torch.float64), counts=launches,
    )
    tracing.count(1, "plan_kernel")
    return out
