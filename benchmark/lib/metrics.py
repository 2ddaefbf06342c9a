"""Arithmetic the metric readers share; each reader is a file of its own
under ``end_to_end/`` or ``layer_metrics/`` with a ``read(ctx)`` that
returns the number, or None where the run has nothing to read.

``ctx``: ``window`` (`lib.window.Window`), ``trace`` (`lib.trace`'s totals
over the kept profiler sessions, or None), ``setup_s``, ``build_s``,
``work`` (``bytes_per_step``, ``flops_per_step``, ``least_s_per_step``
from `lib.roofline`), ``cell`` and ``seconds``.
"""
from __future__ import annotations

import math

__all__ = ["p95", "idle_share", "roofline_share"]


def p95(values):
    """The 95th percentile by nearest rank, over every value."""
    v = sorted(values)
    if not v:
        return None
    return v[max(math.ceil(0.95 * len(v)) - 1, 0)]


def idle_share(ctx):
    """% of the traced window in which no device operation ran."""
    t = ctx.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def roofline_share(ctx):
    """% of a step's device busy time that its least time would take."""
    t = ctx.trace
    if not t or t["busy_s"] <= 0 or not t["steps"]:
        return None
    return 100.0 * ctx.work.least_s_per_step / (t["busy_s"] / t["steps"])
