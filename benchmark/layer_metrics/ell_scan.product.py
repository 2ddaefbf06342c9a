"""ell_scan.product: the ELL buckets a call scans by torch ops (the
reference's per-bucket scan, which the gather engine did not take), the
program's ``ell_scan`` counter over a few spanned steps (tracing on, no
profiler) of an operator rebuilt from the run's matrix after the window,
read as ``ell_launch.product`` reads its counter. Every window call is a
replayed CUDA graph on the card, so the counter is read on replays too: a
program without the counter, or whose graph cache does not count it
again on a replay (``fastsparse_torch.graphs.REPLAYED``), reports
nothing, as do the control and fault runs."""
import importlib

from lib import spans, traffic as traffic_mod
from lib.window import run_step

STEPS = 4  # spanned steps, after an eager one and a captured one per key


def read(ctx):
    loc = spans._run_locals(ctx)
    if loc is None or loc.get("control") or loc.get("wrap_step") is not None:
        return None
    try:
        graphs = importlib.import_module("fastsparse_torch.graphs")
        from fastsparse_torch import tracing
    except ImportError:
        return None
    if "ell_scan" not in getattr(graphs, "REPLAYED", ()):
        return None
    import torch

    import fastsparse_torch as ft

    cell, m, bufs, device = ctx.cell, loc["m"], loc["bufs"], loc["device"]
    cuda = str(device).startswith("cuda")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    op = ft.operator(m, transpose=traffic_mod.needs_transpose(cell.traffic),
                     device=device, **cell.config["operator"])
    step = traffic_mod.make_step(ft, op, cell.traffic)
    for _ in range(2):
        run_step(step, bufs[0], sync)
    got = set()
    for i in range(STEPS):
        with tracing.recording() as rec:
            run_step(step, bufs[i % len(bufs)], sync)
        got.add(rec.counts.get("ell_scan", 0))
    del op, step
    print(f"# ell_scan a step over {STEPS} spanned steps: {sorted(got)}",
          flush=True)
    return got.pop() if len(got) == 1 else None
