"""ops_issued.step: device operations a Macau step enqueues, summed over
its spans' ``ops`` counters, from the spanned steps of `lib.spans`."""
from lib import spans


def read(ctx):
    s = spans.of(ctx)
    return None if s is None else s["ops_per_step"]
