"""roofline_share.valued: the step's least time over its device busy time,
with A's least bytes those of a valued matrix, 4 bytes per stored nonzero
(`lib.roofline_valued`), beside the operand read once and the output
written once in float32, at 3.35 TB/s; the run's matrix is taken from the
frame of `harness.run_cell`, as `lib.spans` takes it."""
from lib import roofline_valued, spans


def read(ctx):
    t = ctx.trace
    loc = spans._run_locals(ctx)
    if not t or t["busy_s"] <= 0 or not t["steps"] or loc is None:
        return None
    m = loc["m"]
    least = roofline_valued.least_s(ctx.cell.traffic, m.nnz, *m.shape)
    return 100.0 * least / (t["busy_s"] / t["steps"])
