"""roofline_share.f64: a step's least time over a float64 matrix (A at 8
bytes a stored value, the operand read and the output written once in
float64, at 3.35 TB/s; `lib.roofline_f64`) over the device time a step of
the program's f64 gather kernel alone (``ell_table_kernel`` in its f64
mode, by name in the traced sessions' device operations); the run's
matrix is taken from the frame of `harness.run_cell`, as `lib.spans`
takes it. Nothing where no session recorded that kernel."""
from lib import roofline_f64, spans


def read(ctx):
    t = ctx.trace
    loc = spans._run_locals(ctx)
    if not t or not t["steps"] or loc is None:
        return None
    k = roofline_f64.kernel_s(t)
    if not k:
        return None
    m = loc["m"]
    least = roofline_f64.least_s(ctx.cell.traffic, m.nnz, *m.shape)
    return 100.0 * least / (k / t["steps"])
