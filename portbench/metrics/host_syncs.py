"""Solver loop (``pyipm_tpu_torch._sync``): host synchronisations a
solve call, from the program's ``COUNTS["host_syncs"]`` over the
window."""

UNIT = "syncs/solve"


def read(ctx):
    return ctx.window.counters["sync"]["host_syncs"] / len(ctx.window.walls)
