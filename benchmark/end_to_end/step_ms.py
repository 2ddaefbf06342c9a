"""step_ms: the whole window over the steps completed in it."""


def read(ctx):
    w = ctx.window
    if not w.steps:
        return None
    return w.window_s / w.steps * 1e3
