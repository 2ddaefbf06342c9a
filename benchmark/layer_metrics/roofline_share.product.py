"""roofline_share.product: the step's least time (its least bytes at
3.35 TB/s, from the problem's shapes) over its device busy time."""
from lib.metrics import roofline_share


def read(ctx):
    return roofline_share(ctx)
