"""host_ms.product: mean host milliseconds of a call, from entry to
return, before its synchronise, over the window's calls outside the
profiler sessions."""


def read(ctx):
    w = ctx.window
    v = [h for h, p in zip(w.host_s, w.profiled) if not p]
    return sum(v) / len(v) * 1e3 if v else None
