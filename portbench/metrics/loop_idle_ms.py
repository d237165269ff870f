"""Solver loop (``core/solver.LoopEngine._loop`` and ``flat_step``): device
idle ms a solve call while the innermost open program scope is
``ipm-loop``: the host's loop between the phases' scopes.  A gap is named
by the scope open at its midpoint (``DeviceTrace.idle_gaps``)."""

SCOPES = ('ipm-loop',)
UNIT = "ms"


def read(ctx):
    tr = ctx.window.trace
    if tr is None or not ctx.window.aligned or not any(
            n in SCOPES for n, _, _ in tr.annotations):
        return None
    want = {f"host in {s}" for s in SCOPES}
    gaps = tr.idle_gaps(len(tr.annotations) + 1)
    return 1e3 * sum(s for n, s in gaps if n in want) / len(ctx.window.walls)
