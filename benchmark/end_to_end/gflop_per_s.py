"""gflop_per_s: 2·nnz·N for every step completed in the window, over the
whole window (one caller, each step followed by a synchronise)."""


def read(ctx):
    w = ctx.window
    if not w.steps or w.window_s <= 0:
        return None
    return ctx.work.flops_per_step * w.steps / w.window_s / 1e9
