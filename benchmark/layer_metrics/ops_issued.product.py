"""ops_issued.product: device operations a call enqueues, summed over its
spans' ``ops`` counters (kernel launches and the torch ops of each spanned
site), from the spanned steps of `lib.spans`."""
from lib import spans


def read(ctx):
    s = spans.of(ctx)
    return None if s is None else s["ops_per_step"]
