"""sync_wait_ms.step: host milliseconds a Macau step waits in the CG's
read-backs, the ``cg.sync`` spans summed over the step, from the spanned
steps of `lib.spans`."""
from lib import spans


def read(ctx):
    s = spans.of(ctx)
    return None if s is None else s["sync_ms"]
