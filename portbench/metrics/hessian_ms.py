"""Autodiff (``core/problem.Problem.hess_lagrangian``): device busy ms a
solve call inside the program's scopes ``ipm-hessian``, d2f - d2ce - d2ci
by ``torch.func`` or the user's overrides. A traced run times each scope
with a pair of CUDA events and places it on the profiler's timeline
(``tracing.align_spans``)."""

SCOPES = ('ipm-hessian',)
UNIT = "ms"


def read(ctx):
    tr = ctx.window.trace
    if tr is None or not ctx.window.aligned:
        return None
    busy = tr.busy_in(set(SCOPES))
    return 1e3 * busy / len(ctx.window.walls) if busy > 0 else None
