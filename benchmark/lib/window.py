"""The measured window: one caller in a closed loop.

Each step runs the traffic's ops on the next operand buffer, then waits
for the device (``sync``), as a Gibbs sampler waits on each product before
the next. The host clock times every step from its first op's entry to
the end of its synchronise, and its ops from entry to return. The
window runs for ``seconds`` and ends with the step in flight, so every
step that started is counted; its length is from the first step's start
to the last step's end.

A sample of the steps' outputs, drawn from the seed by reservoir sampling,
is kept for the comparison after the window closes (references only: no
copy runs in the window). Python's garbage collector is off in the window,
so that no collection lands in a step. With ``sessions``, short
torch.profiler sessions run inside the window, each over a few whole
steps; those steps are flagged, and the host-span metrics leave them out.
A session on the card records CUDA activity only (the device's kernels
and copies, and the host's CUDA runtime calls), not every torch op on the
host, which would slow the steps it measures several times over.
"""
from __future__ import annotations

import dataclasses
import gc
import time

__all__ = ["Window", "run_window", "run_step"]


@dataclasses.dataclass
class Window:
    steps: int = 0
    window_s: float = 0.0
    step_s: list = dataclasses.field(default_factory=list)
    host_s: list = dataclasses.field(default_factory=list)
    profiled: list = dataclasses.field(default_factory=list)
    samples: list = dataclasses.field(default_factory=list)  # (buf, outs)
    sessions: list = dataclasses.field(default_factory=list)  # (prof, n)


def run_step(step, x, sync):
    """Run the ops of ``step`` on ``x`` and wait for the device. Returns
    (outputs, host seconds of the ops, seconds of the whole step)."""
    outs = []
    t0 = time.perf_counter()
    for fn in step:
        x = fn(x)
        outs.append(x)
    t1 = time.perf_counter()
    sync()
    t2 = time.perf_counter()
    return outs, t1 - t0, t2 - t0


def run_window(step, bufs, seconds, sync, rng, keep=8, sessions=()):
    """Run the window. ``sessions``: ``(start offset s, steps)`` of each
    profiler session, in order; ``rng``: a seeded ``random.Random`` that
    draws the kept sample."""
    w = Window()
    plan = list(sessions)
    nb = len(bufs)
    gc.collect()
    gc.disable()
    try:
        _loop(w, step, bufs, seconds, sync, rng, keep, plan, nb)
    finally:
        gc.enable()
    return w


def _loop(w, step, bufs, seconds, sync, rng, keep, plan, nb):
    t_start = time.perf_counter()
    deadline = t_start + seconds
    t_end = t_start
    i = 0
    while True:
        if plan and time.perf_counter() - t_start >= plan[0][0]:
            _, n = plan.pop(0)
            w.sessions.append(_session(step, bufs, i, n, sync, w))
            i += n
        else:
            outs, host, dur = run_step(step, bufs[i % nb], sync)
            w.step_s.append(dur)
            w.host_s.append(host)
            w.profiled.append(False)
            _keep(w.samples, keep, rng, i, (i % nb, outs))
            i += 1
        t_end = time.perf_counter()
        if t_end >= deadline:
            break
    w.steps = i
    w.window_s = t_end - t_start


def _keep(samples, keep, rng, i, item):
    if len(samples) < keep:
        samples.append(item)
        return
    j = rng.randrange(i + 1)
    if j < keep:
        samples[j] = item


def _session(step, bufs, i0, n, sync, w):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA if _cuda() else ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        for k in range(n):
            outs, host, dur = run_step(step, bufs[(i0 + k) % len(bufs)],
                                       sync)
            w.step_s.append(dur)
            w.host_s.append(host)
            w.profiled.append(True)
    return prof, n


def _cuda() -> bool:
    import torch

    return torch.cuda.is_available()
