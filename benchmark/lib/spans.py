"""The program's own spans and counters (`fastsparse_torch.tracing`), read
in a phase of their own after a traced run's window.

The window and its profiler sessions run with tracing off, so every metric
read from them is what it was before the program had spans. The phase
comes after the comparison, once per traced run (`of` keeps its result on
``ctx.spans``):

1. it rebuilds the cell's operator from the run's matrix inside a
   recording (the ``build.*`` spans) and warms it on the run's operands;
2. ``SESSIONS`` times over, a stretch of steps that alternate untraced and
   spanned (tracing on, no profiler: the host metrics, the counts and the
   on-cost, one recording a step), then, on the card, a session of the
   window's CUDA-only profiler with tracing on over a few whole steps;
3. in the profiler sessions it fits the profiler's clock to
   ``perf_counter_ns``: each step ends in ``torch.cuda.synchronize()``,
   stamped before and after, and the stamps pair in order with the
   session's ``cudaDeviceSynchronize`` records; the offset is the median
   of the midpoints' differences. Sessions that lost at most
   ``KEEP_LOSS`` of the device records a step that the most complete
   session holds (`lib.trace`'s rule, with that margin: this phase runs
   late in a run, where the profiler loses a record or two in most
   sessions) then name each idle stretch of the device by the
   program's innermost span at that time, the stretch split where the
   innermost span changes, with the CUDA runtime call the host was in
   beside it (``assemble/cudaLaunchKernel``); time no span holds is
   ``outside`` (the benchmark's loop).

The harness gives readers no handle on the run's matrix, operands or
device, and no seed; the phase takes them from the frame of
`harness.run_cell` that called the reader. A program without
``fastsparse_torch.tracing`` (or a run with no such frame, or a control or
fault run) has no spans, and every reader of them returns None.
"""
from __future__ import annotations

import bisect
import gc
import statistics
import sys
import time
import traceback

from . import trace, traffic as traffic_mod

__all__ = ["of", "fit_offset", "idle_by_span", "innermost_timeline",
           "reduce_sessions"]

SESSIONS = 12
SESSION_S = 0.05  # profiler steps per session: about this long, as the window's
PHASE_SHARE = 0.2  # of the window's seconds, at most PHASE_MAX_S
PHASE_MAX_S = 10.0
MIN_ANCHORS = 8  # stamped synchronises per profiler session, at least
# device records a session may have lost and still be read: the profiler
# drops records in spells, more late in a run, where this phase runs
KEEP_LOSS = 0.005
OUTSIDE = "outside"
LAUNCHES = ("cudaLaunch", "cuLaunch")
ISSUES = LAUNCHES + ("cudaMemcpy", "cudaMemset")
_MISSING = object()


def _say(*a):
    print("# spans:", *a, flush=True)


def of(ctx):
    """The phase's readings for the run of ``ctx`` (None without spans),
    computed at the first call and kept on ``ctx.spans``."""
    got = getattr(ctx, "spans", _MISSING)
    if got is _MISSING:
        try:
            got = _phase(ctx)
        except Exception:  # the per-layer readings are optional; report
            _say("the phase failed; its metrics are left out")
            traceback.print_exc(file=sys.stdout)
            got = None
        ctx.spans = got
    return got


def _run_locals(ctx):
    f = sys._getframe(1)
    while f is not None:
        if f.f_code.co_name == "run_cell" and f.f_locals.get("ctx") is ctx:
            return f.f_locals
        f = f.f_back
    return None


def _phase(ctx):
    loc = _run_locals(ctx)
    if loc is None or loc.get("control") or loc.get("wrap_step") is not None:
        return None
    try:
        from fastsparse_torch import tracing
    except ImportError:
        return None
    import torch

    import fastsparse_torch as ft

    cell, m, bufs, device = ctx.cell, loc["m"], loc["bufs"], loc["device"]
    cuda = str(device).startswith("cuda")
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    with tracing.recording() as rec:
        op = ft.operator(m, transpose=traffic_mod.needs_transpose(cell.traffic),
                         device=device, **cell.config["operator"])
        sync()
    build = {}
    for s in rec.spans:
        build[s.name] = build.get(s.name, 0.0) + (s.t1 - s.t0) / 1e9
    _say("build seconds by span", {k: round(v, 4) for k, v in build.items()})

    step = traffic_mod.make_step(ft, op, cell.traffic)
    for b in bufs:
        _timed(step, b, sync)
    est = sorted(_timed(step, bufs[i % len(bufs)], sync)[1]
                 for i in range(5))[2]
    _say("off-cost", _off_cost(tracing, step, bufs[0], sync))

    stretch = min(PHASE_MAX_S, PHASE_SHARE * ctx.seconds) / SESSIONS
    n_prof = min(max(round(SESSION_S / max(est, 1e-6)), 2), 400)
    # sessions of few steps add synchronises on the idle device after each
    # step's own, and fit the clock on those
    per_step = 1 if n_prof >= MIN_ANCHORS else 1 + -(-MIN_ANCHORS // n_prof)
    pairs, recs, sessions = [], [], []
    nb, i = len(bufs), 0
    gc.collect()
    gc.disable()
    try:
        for _ in range(SESSIONS):
            t_end = time.perf_counter() + stretch
            while True:
                off = _timed(step, bufs[i % nb], sync)
                with tracing.recording() as r:
                    on = _timed(step, bufs[(i + 1) % nb], sync)
                pairs.append((off, on))
                recs.append(r)
                i += 2
                if time.perf_counter() >= t_end:
                    break
            if cuda:
                sessions.append(_session(tracing, step, bufs, i, n_prof,
                                         per_step, sync))
                i += n_prof
    finally:
        gc.enable()
    del op, step
    out = _reduce_steps(recs, cell)
    _on_cost(pairs)
    if sessions:
        out.update(reduce_sessions(sessions, ctx.trace, out))
    return out


def _timed(step, x, sync):
    """(host s, step s) of one step: its ops from entry to return, and to
    the end of its synchronise."""
    t0 = time.perf_counter()
    for fn in step:
        x = fn(x)
    t1 = time.perf_counter()
    sync()
    return t1 - t0, time.perf_counter() - t0


def _off_cost(tracing, step, x, sync):
    """The host cost of the span and count calls with tracing off: their
    number in one step, each call's cost on this host, and their product."""
    n = {"span": 0, "count": 0}
    span, count = tracing.span, tracing.count

    def spy_span(*a, **k):
        n["span"] += 1
        return span(*a, **k)

    def spy_count(*a, **k):
        n["count"] += 1
        return count(*a, **k)
    tracing.span, tracing.count = spy_span, spy_count
    try:
        _timed(step, x, sync)
    finally:
        tracing.span, tracing.count = span, count
    reps = 200_000
    t = time.perf_counter()
    for _ in range(reps):
        with span("product", op="matmat", N=1):
            pass
    span_ns = (time.perf_counter() - t) / reps * 1e9
    t = time.perf_counter()
    for _ in range(reps):
        count(2)
    count_ns = (time.perf_counter() - t) / reps * 1e9
    return {"spans a step": n["span"], "counts a step": n["count"],
            "ns a span": round(span_ns, 1), "ns a count": round(count_ns, 1),
            "us a step": round((n["span"] * span_ns
                                + n["count"] * count_ns) / 1e3, 3)}


def _on_cost(pairs):
    def mean(v):
        return sum(v) / len(v)
    off_h, off_s = mean([p[0][0] for p in pairs]), mean([p[0][1] for p in pairs])
    on_h, on_s = mean([p[1][0] for p in pairs]), mean([p[1][1] for p in pairs])
    _say(f"on-cost over {len(pairs)} pairs: a spanned step {on_s * 1e3:.4f} ms,"
         f" an untraced one {off_s * 1e3:.4f} ms "
         f"({(on_s / off_s - 1) * 100:+.2f} %); host {on_h * 1e3:.4f} against "
         f"{off_h * 1e3:.4f} ms ({(on_h / off_h - 1) * 100:+.2f} %)")


def _reduce_steps(recs, cell):
    """Per-step readings of the spanned steps (one recording each)."""
    n = len(recs)
    totals = sorted({r.counts.get("ops", 0) for r in recs})
    self_ns, ops = {}, {}
    normal, sync_ns = [], 0
    for r in recs:
        for s in r.spans:
            self_ns[s.name] = self_ns.get(s.name, 0) + s.self_ns
            ops[s.name] = ops.get(s.name, 0) + s.counts.get("ops", 0)
            if s.name == "cg.sync":
                sync_ns += s.t1 - s.t0
            elif (s.name == "product" and s.attrs.get("op") == "normal_matmat"
                  and s.root.name == "cg.solve" and not _in_product(s)):
                normal.append(s.t1 - s.t0)
    _say(f"ops per step over {n} spanned steps: {totals}; by span "
         f"{ {k: v / n for k, v in sorted(ops.items())} }")
    _say("host self ms per step by span",
         {k: round(v / n / 1e6, 5) for k, v in sorted(self_ns.items())})
    solves = any(s["op"] == "cg_normal" for s in cell.traffic["step"])
    return {
        "steps": n,
        "ops_per_step": totals[0] if len(totals) == 1 else None,
        "self_ms": {k: v / n / 1e6 for k, v in self_ns.items()},
        "normal_ms": sum(normal) / len(normal) / 1e6 if normal else None,
        "sync_ms": sync_ns / n / 1e6 if solves and "cg.sync" in ops else None,
    }


def _in_product(s):
    p = s.parent
    while p is not None:
        if p.name == "product":
            return True
        p = p.parent
    return False


def _session(tracing, step, bufs, i0, n, per_step, sync):
    """One profiler session with tracing on over ``n`` steps, each ending
    in ``per_step`` stamped synchronises: ``(before, after, extra)``, the
    first the step's own (``extra`` False)."""
    from torch.profiler import ProfilerActivity, profile

    stamps = []
    clock = time.perf_counter_ns
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with tracing.recording() as rec:
            for k in range(n):
                x = bufs[(i0 + k) % len(bufs)]
                for fn in step:
                    x = fn(x)
                for k in range(per_step):
                    a = clock()
                    sync()
                    stamps.append((a, clock(), k > 0))
    return _records(prof) + (rec.spans, stamps, n)


def _records(prof):
    """(device records, CUDA runtime calls) of a session, each as
    ``(start_ns, end_ns, name)`` on the profiler's clock."""
    dev, runtime = [], []
    for e in prof.profiler.kineto_results.events():
        rec = (e.start_ns(), e.end_ns(), e.name())
        if str(e.device_type()).endswith("CUDA"):
            dev.append(rec)
        elif rec[2].startswith("cu"):
            runtime.append(rec)
    return dev, runtime


def _quartile_spread(v):
    if len(v) < 2:
        return 0.0
    q = statistics.quantiles(v, n=4)
    return q[2] - q[0]


def fit_offset(stamps, sync_records, use=None):
    """(offset ns, interquartile spread ns) of the profiler's clock over
    ``perf_counter_ns``: ``stamps`` are ``(before, after, ...)`` host
    stamps of synchronises in order, ``sync_records`` the session's
    ``cudaDeviceSynchronize`` records in order (the profiler may add a few
    of its own at either end: the alignment with the tightest fit wins).
    The offset is the median of the midpoints' differences over the stamps
    ``use`` marks (all by default). None when there are fewer records than
    stamps."""
    recs = sorted(sync_records)
    k = len(stamps)
    if not k or len(recs) < k:
        return None
    pick = [i for i in range(k) if use is None or use[i]]
    best = None
    for j in range(len(recs) - k + 1):
        d = [(recs[j + i][0] + recs[j + i][1]) / 2
             - (stamps[i][0] + stamps[i][1]) / 2 for i in pick]
        fit = (statistics.median(d), _quartile_spread(d))
        if best is None or fit[1] < best[1]:
            best = fit
    return best


def innermost_timeline(spans, offset=0):
    """``[(t, name)]``: from each time on (spans' times plus ``offset``),
    the innermost open span's name, ``OUTSIDE`` where none is. ``spans`` in
    the order they opened, properly nested (one thread)."""
    out, stack = [], []
    for s in spans:
        t0, t1 = s.t0 + offset, s.t1 + offset
        while stack and stack[-1][0] <= t0:
            end = stack.pop()[0]
            out.append((end, stack[-1][1] if stack else OUTSIDE))
        stack.append((t1, s.name))
        out.append((t0, s.name))
    while stack:
        end = stack.pop()[0]
        out.append((end, stack[-1][1] if stack else OUTSIDE))
    return out


def _timeline_name(timeline, t, j):
    """The name at time ``t`` and the index to resume from (times that
    never decrease)."""
    while j < len(timeline) and timeline[j][0] <= t:
        j += 1
    return (timeline[j - 1][1] if j else OUTSIDE), j


def idle_by_span(dev, runtime, timeline):
    """Seconds of device idle by ``span/runtime call``, over the traced
    window from the first runtime call to the last; each idle stretch is
    split where the innermost span changes, each piece named at its
    midpoint. Returns (dict, idle s, busy s, window s)."""
    lo = min(s for s, _, _ in runtime)
    hi = max(e for _, e, _ in runtime)
    busy = trace._union([(max(s, lo), min(e, hi)) for s, e, _ in dev
                         if e > lo and s < hi])
    name_at = trace._namer(runtime)
    cuts = [t for t, _ in timeline]
    out, idle, j = {}, 0.0, 0
    t = lo
    for s, e in busy + [[hi, hi]]:
        if s > t:
            edges = ([t] + cuts[bisect.bisect_right(cuts, t):
                                bisect.bisect_left(cuts, s)] + [s])
            for a, b in zip(edges, edges[1:]):
                mid = (a + b) / 2
                span, j = _timeline_name(timeline, mid, j)
                key = f"{span}/{name_at(mid)}"
                out[key] = out.get(key, 0.0) + (b - a) / 1e9
            idle += (s - t) / 1e9
        t = max(t, e)
    return out, idle, sum(e - s for s, e in busy) / 1e9, (hi - lo) / 1e9


def _inside(records, timeline, want=None):
    """{innermost span name: count} of the records' midpoints."""
    out, j = {}, 0
    for s, e, name in sorted(records, key=lambda r: r[0] + r[1]):
        if want is not None and not name.startswith(want):
            continue
        span, j = _timeline_name(timeline, (s + e) / 2, j)
        out[span] = out.get(span, 0) + 1
    return out


def reduce_sessions(sessions, window_trace, steps_out):
    """``sessions``: ``[(device records, runtime calls, spans, stamps,
    steps)]``; ``window_trace``: `lib.trace`'s totals of the window's
    sessions (their device records a step), or None."""
    full = window_trace["records_per_step"] if window_trace else 0
    read = sessions
    for dev, _, _, _, n in read:
        if dev:
            full = max(full, len(dev) / n)
    idle, gaps, busy, wall, steps, spreads = 0.0, {}, 0.0, 0.0, 0, []
    own_spreads = []
    launches, in_span, syncs, in_sync = 0, 0, 0, 0
    issued, ops = {}, {}
    lost = []
    for dev, runtime, spans_, stamps, n in read:
        lost.append(round(full - len(dev) / n, 3))
        if not dev or not runtime or len(dev) / n < full * (1 - KEEP_LOSS):
            continue
        syncs_ = [r for r in runtime if r[2] == "cudaDeviceSynchronize"]
        extra = [s[2] for s in stamps]
        fit = fit_offset(stamps, syncs_, extra if any(extra) else None)
        if fit is None:
            continue
        offset, spread = fit
        spreads.append(spread / 1e3)
        if any(extra):
            own = fit_offset(stamps, syncs_, [not e for e in extra])
            own_spreads.append(own[1] / 1e3)
        tl = innermost_timeline(spans_, offset)
        g, i_s, b_s, w_s = idle_by_span(dev, runtime, tl)
        for k, v in g.items():
            gaps[k] = gaps.get(k, 0.0) + v
        idle, busy, wall, steps = idle + i_s, busy + b_s, wall + w_s, steps + n
        lk = _inside(runtime, tl, LAUNCHES)
        launches += sum(lk.values())
        in_span += sum(v for k, v in lk.items() if k != OUTSIDE)
        sk = _inside(runtime, tl, "cudaStreamSynchronize")
        syncs += sum(sk.values())
        in_sync += sk.get("cg.sync", 0)
        for k, v in _inside(runtime, tl, ISSUES).items():
            issued[k] = issued.get(k, 0) + v
        for s in spans_:
            ops[s.name] = ops.get(s.name, 0) + s.counts.get("ops", 0)
    _say(f"device records a step lost by session, of {full}: {lost}")
    if not steps:
        _say(f"no profiler session within {KEEP_LOSS:.1%} of {full} device "
             f"records a step")
        return {}
    per = {k: v / steps for k, v in gaps.items()}
    top = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    outside = sum(v for k, v in gaps.items() if k.startswith(OUTSIDE + "/"))
    _say(f"clock fit: interquartile spread by kept session (us) "
         f"{[round(s, 3) for s in spreads]}"
         + (f"; on the steps' own synchronises alone "
            f"{[round(s, 3) for s in own_spreads]}" if own_spreads else ""))
    _say(f"{len(spreads)} of {len(read)} sessions kept, {steps} steps, "
         f"{full} device records a step; ops a step (spanned steps) "
         f"{steps_out['ops_per_step']}")
    _say(f"idle a step {idle / steps * 1e3:.4f} ms of {wall / steps * 1e3:.4f}"
         f" (busy {busy / steps * 1e3:.4f}); under {OUTSIDE} "
         f"{outside / max(idle, 1e-12) * 100:.2f} % of the idle")
    _say("idle_by_span (s a step)", [[k, v] for k, v in top])
    _say(f"kernel launches inside a span: {in_span} of {launches} "
         f"({in_span / max(launches, 1) * 100:.2f} %); "
         f"cudaStreamSynchronize inside cg.sync: {in_sync} of {syncs}")
    _say("ops against the runtime calls that issue device work, inside each "
         "span, a step", {k: [ops.get(k, 0) / steps, issued.get(k, 0) / steps]
                          for k in sorted(set(ops) | set(issued))})
    return {"idle_by_span": top, "outside_share": outside / max(idle, 1e-12),
            "clock_spread_us": spreads}
