"""idle_share.product: % of the traced window in which no device operation
ran, over the profiler sessions that kept every device record."""
from lib.metrics import idle_share


def read(ctx):
    return idle_share(ctx)
