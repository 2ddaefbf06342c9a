"""host_ms.assemble.step: host milliseconds a step spends in the self time of the
program's ``assemble`` spans (enqueueing, not the device's work), from the
spanned steps of `lib.spans`."""
from lib import spans


def read(ctx):
    s = spans.of(ctx)
    return None if s is None else s["self_ms"].get("assemble")
