"""build_s: host seconds of the ``operator(...)`` call at set-up, to the
end of a synchronise."""


def read(ctx):
    return ctx.build_s
