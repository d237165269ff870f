"""End to end: the window's wall over the solve calls it completed (host
clock; each call ends once the device has finished)."""

KIND = "end_to_end"
UNIT = "s"


def read(ctx):
    return ctx.window.seconds / len(ctx.window.walls)
