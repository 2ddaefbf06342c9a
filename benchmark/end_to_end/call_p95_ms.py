"""call_p95_ms: the 95th percentile, by nearest rank, over every step of
the window, each timed from issue to the end of its synchronise."""
from lib.metrics import p95


def read(ctx):
    v = p95(ctx.window.step_s)
    return None if v is None else v * 1e3
