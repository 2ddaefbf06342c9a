"""setup_s: seconds from process start to the first timed step."""


def read(ctx):
    return ctx.setup_s
