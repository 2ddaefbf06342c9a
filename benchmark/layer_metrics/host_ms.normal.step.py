"""host_ms.normal.step: mean host milliseconds of one normal product inside
the CG solve, the outermost ``product`` spans of op ``normal_matmat`` under
``cg.solve``, from the spanned steps of `lib.spans`."""
from lib import spans


def read(ctx):
    s = spans.of(ctx)
    return None if s is None else s["normal_ms"]
