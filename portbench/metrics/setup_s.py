"""End to end: process start to the first timed solve (imports, the
kernel build on a checkout's first run, the draw, the problem, the
warm-up solve)."""

KIND = "end_to_end"
UNIT = "s"


def read(ctx):
    return ctx.setup_s
