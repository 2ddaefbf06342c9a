"""Kernel and product timing on the card with CUDA events.

Replaces the reference's fetch-and-RTT machinery (``fastsparse/bench/
timing.py``), which existed for a remote TPU whose dispatches returned
before the device ran. Here a CUDA event pair brackets a batch of calls on
the current stream: warm up, then time ``batches`` batches of ``reps`` calls
each and report the per-call minimum and median. No card, no number: the
timer raises on a CPU-only host.

`time_queued` keeps the host out of the reading: a spin kernel holds the
stream while the host queues a batch behind it, so the calls run back to
back and the event pair reads device time and launch gaps alone.

`kernel_device_ms` and `device_busy_ms` read device time from
torch.profiler (imported inside them: the package imports this module),
and `bound` gives the least time the card could take for a piece of work.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

__all__ = ["time_cuda", "time_queued", "device_us", "kernel_device_ms",
           "device_busy_ms", "bound"]

# H100 SXM peaks (NVIDIA data sheet, dense, at the full 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12


def time_cuda(fn: Callable, *args, reps: int = 20, batches: int = 5,
              warmup: int = 3) -> dict:
    """Per-call milliseconds of ``fn(*args)`` on the current CUDA stream.

    Returns ``{"min_ms", "median_ms", "samples_ms"}``; each sample is one
    batch's event-timed total over ``reps``."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_cuda needs a CUDA device")
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    samples = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args)
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / reps)
    samples.sort()
    return {
        "min_ms": samples[0],
        "median_ms": samples[len(samples) // 2],
        "samples_ms": samples,
    }


def time_queued(fn: Callable, *args, reps: int = 20, batches: int = 5,
                hold_ms: float = 2.0, tries: int = 4) -> dict | None:
    """Per-call device milliseconds of ``fn(*args)``, queued: each batch of
    ``reps`` calls is enqueued behind ``torch.cuda._sleep`` (``hold_ms`` at
    2 GHz), with the start event after the spin, so the device runs the
    batch without waiting on the host. A batch whose start event had
    already fired when the host finished queueing (the spin ended first,
    or ``fn`` waited on the device) is taken again with twice the hold, up
    to ``tries`` times; then the result is None. Returns ``{"min_ms",
    "median_ms", "samples_ms"}`` like `time_cuda`."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_queued needs a CUDA device")
    fn(*args)
    torch.cuda.synchronize()
    samples = []
    for _ in range(batches):
        hold = hold_ms
        for _ in range(tries):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(hold * 2e6))
            start.record()
            for _ in range(reps):
                fn(*args)
            stop.record()
            queued = not start.query()
            stop.synchronize()
            if queued:
                samples.append(start.elapsed_time(stop) / reps)
                break
            hold *= 2
        else:
            return None
    samples.sort()
    return {
        "min_ms": samples[0],
        "median_ms": samples[len(samples) // 2],
        "samples_ms": samples,
    }


def bound(nbytes: float, ops: float = 0.0,
          ops_per_s: float = F32_OPS_PER_S) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the type's peak, whichever is larger. Returns
    ``{"bound_ms", "bound_by"}``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def device_us(e) -> float:
    """A profiler row's device time in µs (the attribute's name differs
    between torch versions)."""
    t = getattr(e, "self_device_time_total", None)
    return getattr(e, "self_cuda_time_total", 0.0) if t is None else t


def _device_rows(fn: Callable, n: int):
    """``(count, device µs, name)`` of each device row of ``n`` calls of
    ``fn()`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return [(e.count, device_us(e), e.key) for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]


def kernel_device_ms(fn: Callable, keys, per_call: int | None = 1,
                     n: int = 5, tries: int = 3) -> float | None:
    """Device ms per call of the kernels whose names hold one of ``keys``
    (``("",)``: every kernel) under torch.profiler: the mean over the
    launch records a session kept times ``per_call``, the launches one call
    makes (the profiler drops whole calls' records now and then);
    ``per_call=None``: the records' sum over the ``n`` calls (a library
    call of several kernels). A session that kept none is profiled again
    half a second later; None if none did."""
    fn()
    torch.cuda.synchronize()
    for i in range(tries):
        if i:
            time.sleep(0.5)
        rows = [(c, t) for c, t, key in _device_rows(fn, n)
                if any(k in key for k in keys)]
        if rows:
            total_ms = sum(t for _, t in rows) / 1e3
            if per_call is None:
                return total_ms / n
            return total_ms / sum(c for c, _ in rows) * per_call
    return None


def device_busy_ms(fn: Callable, *args, n: int = 5):
    """Device time per call of ``fn(*args)`` (the sum of its kernels'
    device times) under torch.profiler, and the top kernels by device
    time; ``(None, [])`` when the profiler sees no device time."""
    fn(*args)
    torch.cuda.synchronize()
    rows = sorted(((t / 1e3 / n, key) for _, t, key in
                   _device_rows(lambda: fn(*args), n) if t > 0),
                  reverse=True)
    if not rows:
        return None, []
    return sum(t for t, _ in rows), rows[:6]
