"""From the window's profiler sessions to device busy time, idle gaps and
the device operations by name.

torch.profiler on the card drops the device records of some sessions, in
spells (the program's kernels' records more than the library's), so a
session is kept only where its device records per step equal those of the
most complete session: the steps of every cell are deterministic, so a
complete session has the most. The arithmetic is that of
``fastsparse_torch/bench/spmv_kernels.kernel_device_ms`` (device time from
the records a session kept, against the calls it covered), taken here over
whole steps and with the sessions that lost records left out instead of
scaled up.

In a kept session, the traced window runs from the start of its first CUDA
runtime call to the end of its last (each step ends in a synchronise), on
the profiler's clock; busy time is the union of the device records'
intervals inside it. Each idle stretch is named by what the host was doing
at its midpoint: the CUDA runtime call that holds it ("sync" for a
synchronise, where the host waits on the device), or "host" between
runtime calls (Python and torch's dispatch). The benchmark's own spans
cannot name them: a session that records CUDA activity alone keeps no
host range.
"""
from __future__ import annotations

__all__ = ["session_records", "reduce_sessions"]

NAME_CHARS = 96


def session_records(prof) -> tuple[list, list]:
    """(device records, CUDA runtime calls) of one session, each as
    ``(start_us, end_us, name)``, read from the profiler's raw results:
    its parsed event list costs minutes over a traced Macau window."""
    dev, runtime = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        rec = (e.start_ns() / 1e3, e.end_ns() / 1e3, name)
        if str(e.device_type()).endswith("CUDA"):
            dev.append(rec)
        elif name.startswith("cu"):
            runtime.append(rec)
    return dev, runtime


def _union(ivs):
    out = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _namer(runtime):
    """A function from a time to what the host was doing then; it is
    called at times that never decrease, and sweeps the calls once."""
    calls = sorted(runtime)
    active = []
    j = 0

    def name_at(t):
        nonlocal j
        while j < len(calls) and calls[j][0] <= t:
            active.append(calls[j])
            j += 1
        active[:] = [c for c in active if c[1] >= t]
        if not active:
            return "host"
        name = min(active, key=lambda c: c[1] - c[0])[2]
        return "sync" if "Synchronize" in name else name
    return name_at


def reduce_sessions(sessions) -> dict | None:
    """``sessions``: ``[(device records, runtime calls, steps)]``. Returns
    the traced totals over the kept sessions (seconds), or None when no
    session holds a device record and a runtime call."""
    per = [len(d) / n for d, rt, n in sessions if n and d and rt]
    if not per:
        return None
    full = max(per)
    busy = wall = 0.0
    steps = 0
    kept = 0
    ops: dict = {}
    gaps: dict = {}
    for dev, runtime, n in sessions:
        if not n or not dev or not runtime or len(dev) / n != full:
            continue
        kept += 1
        lo = min(s for s, _, _ in runtime)
        hi = max(e for _, e, _ in runtime)
        clipped = [(max(s, lo), min(e, hi)) for s, e, _ in dev
                   if e > lo and s < hi]
        union = _union(clipped)
        busy += sum(e - s for s, e in union)
        wall += hi - lo
        steps += n
        for s, e, name in dev:
            key = name[:NAME_CHARS]
            ops[key] = ops.get(key, 0.0) + (e - s)
        t = lo
        name_at = _namer(runtime)
        for s, e in union + [[hi, hi]]:
            if s > t:
                key = name_at((s + t) / 2)
                gaps[key] = gaps.get(key, 0.0) + (s - t)
            t = max(t, e)
    us = 1e-6
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy * us,
        "window_s": wall * us,
        "steps": steps,
        "records_per_step": full,
        "sessions_kept": kept,
        "sessions": len(sessions),
        "per_session": [round(len(d) / n, 3) if n else 0
                        for d, _, n in sessions],
        "device_ops": [[k, v * us] for k, v in top],
        "idle_gaps": [[k, v * us] for k, v in idle],
    }
