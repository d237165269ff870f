"""Device: kernel launches a solve call, counted in the traced window."""

UNIT = "launches/solve"


def read(ctx):
    tr = ctx.window.trace
    if tr is None:
        return None
    n = tr.launches()
    return n / len(ctx.window.walls) if n else None
