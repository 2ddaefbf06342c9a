"""Counts of an operator's layout, printed on a run's first lines.

A seed draws a new matrix, and a new matrix can change the layout the
program builds for it (buckets, panels, dense columns, assembly plans), and
with it the work of a call. The counts come from walking the operator's
dataclasses generically, by class name, so a layout that a later change of
the program adds is counted without an edit here.
"""
from __future__ import annotations

import dataclasses

__all__ = ["layout_counts", "plan_ops", "launch_counts"]


def _walk(obj, seen):
    if obj is None or id(obj) in seen:
        return
    if isinstance(obj, (list, tuple)):
        for o in obj:
            _walk(o, seen)
        return
    if not dataclasses.is_dataclass(obj) or isinstance(obj, type):
        return
    seen[id(obj)] = obj
    for f in dataclasses.fields(obj):
        _walk(getattr(obj, f.name, None), seen)


def plan_ops(plan) -> tuple[int, int]:
    """(row gathers, adds) one application of an assembly plan issues:
    a class of multiplicity w gathers w slot panels and adds them (w - 1
    adds), then one gather puts the classes in row order; a strip plan is
    one gather."""
    widths = getattr(plan, "widths", None)
    if widths is None:
        return 1, 0
    gathers = sum(int(w) for w in widths) + 1
    adds = sum(max(int(w) - 1, 0) for w in widths)
    gathers += len(getattr(plan, "row_srcs", ()) or ())
    adds += max(len(getattr(plan, "row_srcs", ()) or ()) - 1, 0)
    return gathers, adds


def layout_counts(op) -> dict:
    """``{"fwd": {...}, "bwd": {...}}``: per tiling, the number of objects
    of each layout class, and the row gathers and adds of its plans."""
    out = {}
    for side in ("fwd", "bwd"):
        tiling = getattr(op, side, None)
        if tiling is None:
            continue
        seen = {}
        _walk(tiling, seen)
        counts: dict = {}
        gathers = adds = 0
        for obj in seen.values():
            name = type(obj).__name__
            counts[name] = counts.get(name, 0) + 1
            if name.startswith("Mono"):
                key = f"{name}.items"
                counts[key] = counts.get(key, 0) + int(obj.ns)
            if name == "EllBucket":
                counts["EllBucket.slots"] = (counts.get("EllBucket.slots", 0)
                                             + int(obj.cols.numel()))
            if name.endswith("Plan"):
                g, a = plan_ops(obj)
                gathers += g
                adds += a
        dense_cols = [o for o in seen.values()
                      if type(o).__name__ == "DenseCols"]
        if dense_cols:
            counts["dense_cols_D"] = sum(int(d.n_cols) for d in dense_cols)
        counts["plan_gathers"] = gathers
        counts["plan_adds"] = adds
        out[side] = dict(sorted(counts.items()))
    return out


def launch_counts(ft) -> dict:
    """The program's launch counters, ``launches`` of each module of
    ``fastsparse_torch.ops.kernels`` (hand-written kernels only; the
    torch ops of the plans are not counted there), summed by name."""
    import importlib
    import pkgutil

    pkg = importlib.import_module(ft.__name__ + ".ops.kernels")
    out: dict = {}
    for info in pkgutil.iter_modules(pkg.__path__):
        mod = importlib.import_module(f"{pkg.__name__}.{info.name}")
        for k, v in getattr(mod, "launches", {}).items():
            out[k] = out.get(k, 0) + int(v)
    return out
