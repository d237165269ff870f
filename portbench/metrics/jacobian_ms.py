"""Autodiff (``core/problem.Problem.grad_f``, ``jac_ce``, ``jac_ci``):
device busy ms a solve call inside the program's scopes ``ipm-jacobian``,
the first derivatives at every call site. A traced run times each scope
with a pair of CUDA events and places it on the profiler's timeline
(``tracing.align_spans``)."""

SCOPES = ('ipm-jacobian',)
UNIT = "ms"


def read(ctx):
    tr = ctx.window.trace
    if tr is None or not ctx.window.aligned:
        return None
    busy = tr.busy_in(set(SCOPES))
    return 1e3 * busy / len(ctx.window.walls) if busy > 0 else None
