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
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["time_cuda", "time_queued"]


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
