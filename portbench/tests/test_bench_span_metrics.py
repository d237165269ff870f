"""The readers of the program's finer scopes on a synthetic device trace
whose busy and idle time inside each scope is known by hand."""

from types import SimpleNamespace

import pytest

from portbench import registry
from portbench.tracing import DeviceTrace

# device work (s): gaps (1, 2), (3, 5), (6, 8), (9, 10), (11, 13)
WORK = [("k", a, a + 1.0) for a in (0.0, 2.0, 5.0, 8.0, 10.0, 13.0)]
# scope ranges; each gap's midpoint falls in the innermost scope noted
ANNOTATIONS = [
    ("ipm-loop", 0.0, 12.5),          # gaps at 9.5 and 12: 1 + 2 s idle
    ("ipm-direction", 0.5, 3.3),
    ("ipm-hessian", 0.5, 3.2),        # busy 0.5 + 1 s; the gap at 1.5
    ("ipm-kkt-factor", 3.5, 9.2),     # the gap at 7: 2 s idle
    ("ipm-k3-panel", 3.8, 4.2),       # the gap at 4: 2 s idle
    ("ipm-jacobian", 9.8, 11.5),      # busy 1 s
]
CALLS = 2
EXPECTED_MS = {"hessian_ms": 750.0, "jacobian_ms": 500.0,
               "loop_idle_ms": 1500.0}


def _ctx(annotations, aligned=True):
    tr = DeviceTrace(list(WORK), list(annotations), window_s=14.0)
    window = SimpleNamespace(trace=tr, aligned=len(annotations) if aligned
                             else 0, walls=[7.0] * CALLS)
    return SimpleNamespace(window=window)


def test_the_trace_names_each_gap_as_the_readers_expect():
    gaps = dict(_ctx(ANNOTATIONS).window.trace.idle_gaps(100))
    assert gaps == {"host in ipm-loop": 3.0, "host in ipm-k3-panel": 2.0,
                    "host in ipm-kkt-factor": 2.0,
                    "host in ipm-hessian": 1.0}


@pytest.mark.parametrize("name", sorted(EXPECTED_MS))
def test_reader_reads_its_scope(name):
    mod = registry.metric(name)
    assert mod.UNIT == "ms"
    assert mod.read(_ctx(ANNOTATIONS)) == pytest.approx(EXPECTED_MS[name])


@pytest.mark.parametrize("name", sorted(EXPECTED_MS))
def test_reader_is_silent_without_its_scope(name):
    """None where the program opens none of the reader's scopes (a parent
    without them), where the run was not traced or its spans were not
    placed on the trace."""
    mod = registry.metric(name)
    others = [a for a in ANNOTATIONS if a[0] not in mod.SCOPES]
    assert len(others) < len(ANNOTATIONS)
    assert mod.read(_ctx(others)) is None
    assert mod.read(_ctx(ANNOTATIONS, aligned=False)) is None
    ctx = _ctx(ANNOTATIONS)
    ctx.window.trace = None
    assert mod.read(ctx) is None


def test_each_scope_read_is_one_the_program_opens():
    from pyipm_tpu_torch.utils.profiling import SCOPES
    for name in EXPECTED_MS:
        assert set(registry.metric(name).SCOPES) <= set(SCOPES), name
