"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the metrics by their readers.

Set-up is everything from process start to the first timed step: loading
torch and the program, generating the matrix and operands from the seed,
``operator(...)`` with only the tilings the cell uses, loading (on a first
run in a checkout, compiling) the kernel library at the first call, and a
warm-up of the cell's own operands only. Nothing compiles in the window.

After the window closes, the peak of device memory is read, the program's
operator is freed, and the reference recomputes every kept sample's ops in
float64 from the generated matrix; each op's largest gap is held against
the cell's limit for it. The reference's time is not set-up and not window.
"""
from __future__ import annotations

import random
import sys
import time
from types import SimpleNamespace

from . import card, problem, roofline, trace, traffic as traffic_mod
from .layout import launch_counts, layout_counts
from .reference import Reference, rel_gap, tensor_of
from .spec import load_reader
from .window import run_step, run_window

__all__ = ["run_cell", "check_names"]

KEEP = 8  # steps whose outputs the comparison reads
# profiler sessions in a traced window, each over about SESSION_S of steps:
# many short ones, since the profiler drops records in spells and only
# the sessions that kept every record count
SESSIONS = 12
SESSION_S = 0.05


def _say(*a):
    print("#", *a, flush=True)


SOLVE_CHECKS = ("resgap", "iters", "resratio")


def _checks(traffic: dict) -> list[tuple[str, int, str]]:
    """``(name, op index, kind)`` of each compared number of a traffic's
    step: a product has one, ``rel.<op>`` (kind "rel"), its largest gap to
    the float64 reference over the largest reference entry; a solve has
    three, ``<kind>.cg_normal`` for each kind of `SOLVE_CHECKS`
    (`lib.reference`). The op's position is appended where an op
    repeats."""
    out = []
    for k, s in enumerate(traffic["step"]):
        kinds = SOLVE_CHECKS if s["op"] == "cg_normal" else ("rel",)
        for kind in kinds:
            n = f"{kind}.{s['op']}"
            if any(n == o[0] for o in out):
                n = f"{n}.{k}"
            out.append((n, k, kind))
    return out


def check_names(traffic: dict) -> list[str]:
    """The compared numbers of a traffic's step (`_checks`)."""
    return [n for n, _, _ in _checks(traffic)]


def _work(cell, m):
    tr = cell.traffic
    shape = m.shape
    width = int(tr["operand"]["width"])
    nbytes = sum(roofline.op_bytes(s, m.nnz, shape[0], shape[1], width)
                 for s in tr["step"])
    flops = sum(roofline.op_flops(s, m.nnz, width) for s in tr["step"])
    return SimpleNamespace(bytes_per_step=nbytes, flops_per_step=flops,
                           least_s_per_step=roofline.least_s(nbytes, flops))


def _control_step(cell, m, device):
    ref = Reference(m, device, precision="tf32")
    return [lambda x, f=ref.op(s): f(tensor_of(x))
            for s in cell.traffic["step"]]


def run_cell(spec, name, seed, seconds, trace_on, *, device="cuda",
             t_anchor=None, age0=0.0, wrap_step=None, control=False):
    """Run cell ``name`` once; returns the result's dict (``checks``
    last) and the lines of the comparison for standard error.

    ``wrap_step`` (`lib.faults`) takes the step, a list of callables,
    and the program, its operator and the traffic, and returns the step to
    time; ``control=True`` (readings) times the
    reference in TF32 in the program's place."""
    import torch

    import fastsparse_torch as ft

    t_anchor = time.perf_counter() if t_anchor is None else t_anchor
    cell = spec.cell(name)
    cuda = str(device).startswith("cuda")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t = time.perf_counter()
    m = problem.make_matrix(cell.config, seed)
    gen_s = time.perf_counter() - t
    _say(f"cell {name} seed {seed}: {cell.config['generator']}"
         f"{tuple(cell.config['args'].values())} shape {m.shape} "
         f"nnz {m.nnz} (generated in {gen_s:.3f} s)")

    t = time.perf_counter()
    op = ft.operator(m, transpose=traffic_mod.needs_transpose(cell.traffic),
                     device=device, **cell.config["operator"])
    sync()
    build_s = time.perf_counter() - t
    _say(f"operator built in {build_s:.3f} s: {layout_counts(op)}")

    bufs = problem.make_operands(cell.traffic, m.shape, seed, device)
    step = traffic_mod.make_step(ft, op, cell.traffic)
    if control:
        step = _control_step(cell, m, device)
    if wrap_step is not None:
        step = wrap_step(step, SimpleNamespace(ft=ft, op=op,
                                               traffic=cell.traffic))

    t = time.perf_counter()
    before = launch_counts(ft)
    run_step(step, bufs[0], sync)
    first_s = time.perf_counter() - t
    after = launch_counts(ft)
    per_step = {k: v - before.get(k, 0) for k, v in after.items()
                if v != before.get(k, 0)}
    _say(f"first step {first_s:.3f} s (loads the kernel library); "
         f"kernel launches per step {per_step}")
    for b in bufs[1:]:
        run_step(step, b, sync)
    # as many outputs alive at once as the window keeps: the allocator's
    # pool then holds their blocks, and the window allocates nothing new
    held = [run_step(step, bufs[i % len(bufs)], sync)[0]
            for i in range(KEEP + 2)]
    del held
    est = sorted(run_step(step, bufs[i % len(bufs)], sync)[2]
                 for i in range(5))[2]
    sessions = ()
    if trace_on:
        run_window(step, bufs, 0.0, sync, random.Random(0), keep=0,
                   sessions=[(0.0, 1)])
        n = min(max(round(SESSION_S / max(est, 1e-6)), 2), 400)
        sessions = [((k + 0.5) * seconds / SESSIONS, n)
                    for k in range(SESSIONS)]
    warm_s = time.perf_counter() - t
    setup_s = age0 + (time.perf_counter() - t_anchor)
    _say(f"warm-up {warm_s:.3f} s (a step {est * 1e3:.3f} ms); "
         f"set-up {setup_s:.3f} s")

    w = run_window(step, bufs, seconds, sync, random.Random(seed),
                   keep=KEEP, sessions=sessions)
    mem_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    traced = None
    if trace_on:
        recs = [trace.session_records(p) + (n,)
                for p, n in w.sessions]
        traced = trace.reduce_sessions(recs)
    w.sessions = []
    del op, step
    if cuda:
        torch.cuda.empty_cache()

    numbers, failed = _compare(cell, m, bufs, w.samples, device)
    w.samples = []
    checks = {k: {"value": v, "limit": float(cell.limits[k])}
              for k, v in numbers.items()}
    correct = bool(checks) and all(c["value"] <= c["limit"]
                                   for c in checks.values())

    ctx = SimpleNamespace(
        cell=cell, window=w, trace=traced, setup_s=setup_s, build_s=build_s,
        work=_work(cell, m), seconds=seconds,
    )
    kind = "per_layer" if trace_on else "end_to_end"
    entries = cell.per_layer if trace_on else cell.end_to_end
    metrics = {}
    for e in entries:
        v = load_reader(spec, kind, e["name"])(ctx)
        if v is None:
            if not trace_on:
                raise RuntimeError(f"end-to-end metric {e['name']} has no "
                                   f"reading in {name}")
            continue
        metrics[e["name"]] = {"value": float(v), "unit": e["unit"]}

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": mem_peak}
    result = {"correct": correct, "attempted": w.steps, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace_on:
        dev["busy_s"] = traced["busy_s"] if traced else 0.0
        dev["window_s"] = traced["window_s"] if traced else 0.0
        if traced:
            _say(f"trace: {traced['sessions_kept']} of {traced['sessions']} "
                 f"sessions kept, {traced['steps']} steps, "
                 f"{traced['records_per_step']} device records a step; "
                 f"records per step by session {traced['per_session']}")
            result["breakdown"] = {"device_ops": traced["device_ops"],
                                   "idle_gaps": traced["idle_gaps"]}
        _say(_traced_cost(w))
    result["checks"] = checks
    lines = [f"check {k} {c['value']!r} limit {c['limit']!r}"
             for k, c in checks.items()]
    return result, lines


def _traced_cost(w):
    """The mean step inside the profiler sessions against outside them."""
    def mean(flag):
        v = [t for t, p in zip(w.step_s, w.profiled) if p == flag]
        return sum(v) / len(v) * 1e3 if v else float("nan")

    inside, outside = mean(True), mean(False)
    return (f"a traced step {inside:.4f} ms, an untraced one {outside:.4f} "
            f"ms ({(inside / outside - 1) * 100:+.1f} %)")


def _compare(cell, m, bufs, samples, device):
    """Each number's largest reading over the kept samples, and the samples
    with a reading over its limit. The reference's op outputs, its solve
    among them, are computed once per operand buffer, and only as far
    along the step as a kept output needs."""
    checks = _checks(cell.traffic)
    if not samples:
        return {}, 0
    ref = Reference(m, device)
    steps = cell.traffic["step"]
    chains: dict = {}
    solves: dict = {}
    worst = {n: 0.0 for n, _, _ in checks}
    failed = 0

    def ref_out(b, k):
        chain = chains.setdefault(b, [])
        while len(chain) <= k:
            x = chain[-1] if chain else bufs[b]
            chain.append(ref.op(steps[len(chain)])(tensor_of(x)))
        return chain[k]

    def ref_solve(b, k):
        if (b, k) not in solves:
            s = steps[k]
            rhs = bufs[b] if k == 0 else ref_out(b, k - 1)
            solves[b, k] = rhs, ref.cg_normal(
                rhs, float(s["reg"]), float(s["tol"]), int(s["maxiter"]))
        return solves[b, k]

    for b, outs in samples:
        got, solved = {}, {}
        for n, k, kind in checks:
            if kind == "rel":
                got[n] = rel_gap(tensor_of(outs[k]), ref_out(b, k))
                continue
            if k not in solved:
                prog_rhs = bufs[b] if k == 0 else outs[k - 1]
                solved[k] = ref.solve_checks(
                    prog_rhs, outs[k], *ref_solve(b, k),
                    float(steps[k]["reg"]))
            got[n] = solved[k][kind]
        bad = False
        for n, g in got.items():
            worst[n] = max(worst[n], g) if g == g else float("inf")
            bad |= not g <= float(cell.limits[n])
        failed += bad
    return worst, failed


def print_result(result, lines):
    """The comparison's lines last on standard error, the result's JSON
    last on standard output."""
    import json

    for ln in lines:
        print(ln, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def card_banner():
    for ln in card.card_lines():
        _say(f"card: {ln}  [{card.QUERY}]")
