"""device_ops.product: device operations one call runs, the traced
window's device records a step (`lib.trace`, over the profiler sessions
that kept every record): each kernel and copy of an eager call, each
kernel node of a replayed graph and its copy-in and clone."""


def read(ctx):
    t = ctx.trace
    return None if not t or not t["steps"] else t["records_per_step"]
