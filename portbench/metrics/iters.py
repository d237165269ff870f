"""Solver loop (``core/solver.BatchSolver.run``): the mean inner
iterations of the instances solved in the window."""

UNIT = "iterations"


def read(ctx):
    n = sum(a.iter_count.numel() for a in ctx.window.answers)
    tot = sum(float(a.iter_count.double().sum()) for a in ctx.window.answers)
    return tot / n if n else None
