"""Observability of the port (pyipm_tpu_torch): ``trace_metrics``
histories against the JAX package's, the profiling scopes, ``trace``,
``profile_solve``, ``iteration_report``, ``enable_nan_debugging`` and the
CLI's ``--profile``, on the CPU (the counterparts of the JAX package's
test_observability.py).

Tolerance: the history of problem 7 (float64) has the JAX package's T and
its recorded rows within 1e-10."""

import contextlib
import glob
import io
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pyipm_tpu import IPMConfig as JCfg  # noqa: E402
from pyipm_tpu import solve as j_solve  # noqa: E402
from pyipm_tpu.models import REFERENCE_PROBLEMS as J_REF  # noqa: E402
from pyipm_tpu_torch import IPMConfig, make_problem, solve  # noqa: E402
from pyipm_tpu_torch import cli  # noqa: E402
from pyipm_tpu_torch.core.solver import BatchSolver  # noqa: E402
from pyipm_tpu_torch.interop import reference_problem  # noqa: E402
from pyipm_tpu_torch.ops.large_ldlt import (  # noqa: E402
    bwd_sweep_blocks, bwd_sweep_panels, panel_ldlt,
)
from pyipm_tpu_torch.utils import profiling  # noqa: E402
from pyipm_tpu_torch.utils.profiling import (  # noqa: E402
    NOT_IN_SMALL_SOLVE, SCOPES, SolveProfile, enable_nan_debugging,
    iteration_report, profile_solve, trace,
)


def _x0(num=7):
    return J_REF[num].sample_x0(np.random.default_rng(42))


def test_metrics_history_matches_jax():
    """JAX test_observability.py:10 on problem 7, float64."""
    cfg = IPMConfig(Ftol=1e-8, verbosity=0, trace_metrics=True)
    res = solve(reference_problem(7).make(), torch.as_tensor(_x0()), cfg)
    jr = j_solve(J_REF[7].make(), _x0(),
                 JCfg(Ftol=1e-8, verbosity=0, trace_metrics=True))
    T = cfg.niter * cfg.miter
    n = int(res.iter_count)
    assert n == int(jr.iter_count)
    assert res.hist.kkt.shape == tuple(jr.hist.kkt.shape) == (T, 4)
    for k in ("kkt", "mu", "nu", "alpha", "delta"):
        got = getattr(res.hist, k).numpy()
        want = np.asarray(getattr(jr.hist, k))
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got[:n], want[:n], rtol=0, atol=1e-10,
                                   err_msg=k)
        assert np.all(got[n:] == 0), k
    kkt = res.hist.kkt.numpy()
    assert np.all(kkt[:n].sum(axis=1) > 0)
    np.testing.assert_array_equal(kkt[n - 1], res.kkt.numpy())


def test_metrics_off_by_default():
    """JAX test_observability.py:34: no buffers unless asked for; the
    state carries none."""
    prob = reference_problem(1).make()
    res = solve(prob, torch.as_tensor(_x0(1)), IPMConfig(verbosity=0))
    assert res.hist.kkt.shape == (0, 4) and res.hist.mu.shape == (0,)
    solver = BatchSolver(prob, IPMConfig(verbosity=0))
    assert solver.init_state(torch.as_tensor(_x0(1))[None]).hist is None


def test_profile_solve_and_iteration_report():
    """JAX test_observability.py:140."""
    cfg = IPMConfig(Ftol=1e-8, verbosity=0, trace_metrics=True)
    solver = BatchSolver(reference_problem(7).make(), cfg)
    x0 = torch.as_tensor(np.stack([_x0(), _x0()]))
    prof = profile_solve(solver, x0, reps=2)
    assert isinstance(prof, SolveProfile)
    assert prof.compile_s > 0 and prof.execute_s > 0
    assert prof.total_iters and prof.total_iters > 0
    assert prof.backend == "cpu" and not hasattr(prof, "flops")
    assert "execute" in str(prof)
    res = solver(x0)
    rep = iteration_report(res, i=1)
    assert rep.count("\n") >= int(res.iter_count[1])
    assert "mu" in rep
    off = BatchSolver(reference_problem(7).make(), IPMConfig(verbosity=0))
    assert "no metrics recorded" in iteration_report(off(x0))


def _solve_7(solver):
    solve(reference_problem(7).make(), torch.as_tensor(_x0()),
          IPMConfig(verbosity=0, linear_solver=solver))


def _soc_and_wrappers():
    """Problem 4's solve (its line search takes the SOC) and kernels 3-5's
    wrappers on the smallest CPU operands they take."""
    res = solve(reference_problem(4).make(), torch.as_tensor(_x0(4)),
                IPMConfig(verbosity=0))
    assert int(res.signal) == 1
    f64 = dict(dtype=torch.float64)
    eye = torch.eye(128, **f64)
    panel_ldlt(torch.ones((1, 1), **f64))
    bwd_sweep_panels(eye, torch.ones(128, **f64), eye[None])
    bwd_sweep_blocks(torch.ones((1, 1), **f64), torch.ones(1, **f64),
                     torch.ones((1, 1, 1), **f64))


def _every_scope():
    for solver in ("condensed", "ldlt"):
        _solve_7(solver)
    _soc_and_wrappers()


def _events(tmp_path, name, fn):
    """The scope events ``fn()`` leaves in an exported trace: {name: [(ts,
    end, tid)]}."""
    with trace(str(tmp_path / name)):
        fn()
    (path,) = glob.glob(str(tmp_path / name / "*.json"))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    out = {}
    for e in events:
        if e.get("name") in SCOPES and e.get("ph") == "X":
            out.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e["dur"], e.get("tid")))
    return out


def _inside(inner, outer):
    """Every range of ``inner`` lies in a range of ``outer`` on its
    thread."""
    return all(any(a >= oa and b <= ob and t == ot for oa, ob, ot in outer)
               for a, b, t in inner)


def test_scopes_in_a_profiler_trace(tmp_path):
    """Every scope of ``SCOPES`` appears in the exported traces: each solve
    of problem 7 ('condensed', and 'ldlt' to put the factor and solve
    scopes of the full KKT system in it too) opens all but the SOC's and
    kernels 3-5's, which problem 4's solve and the wrappers called alone
    open.  The Hessian's scope nests in the direction's, which nests in
    the loop's.  The counterpart of JAX :165's lowered HLO."""
    seen = set()
    for solver in ("condensed", "ldlt"):
        ev = _events(tmp_path, solver, lambda: _solve_7(solver))
        missing = [s for s in SCOPES
                   if s not in ev and s not in NOT_IN_SMALL_SOLVE]
        assert not missing, (solver, missing)
        assert _inside(ev["ipm-hessian"], ev["ipm-direction"]), solver
        assert _inside(ev["ipm-direction"], ev["ipm-loop"]), solver
        seen |= set(ev)
    ev = _events(tmp_path, "soc", _soc_and_wrappers)
    assert _inside(ev["ipm-soc"], ev["ipm-line-search"])
    missing = [s for s in SCOPES if s not in seen | set(ev)]
    assert not missing, missing


def test_every_scope_goes_through_annotate():
    """The benchmark's traced run replaces ``annotate`` in every module of
    the package that holds it (``portbench/tracing.py``'s
    ``record_spans``) and times a scope on the device its call names: the
    solves and wrapper calls of the trace test enter every scope of
    ``SCOPES``, and no other, through such a replacement, each with the
    device of its tensors."""
    import sys

    orig = profiling.annotate
    entered = []

    @contextlib.contextmanager
    def recording(name, device=None):
        entered.append((name, device))
        with orig(name, device):
            yield

    patched = []
    try:
        for mod_name, mod in list(sys.modules.items()):
            if mod is None or not (mod_name == "pyipm_tpu_torch" or
                                   mod_name.startswith("pyipm_tpu_torch.")):
                continue
            for attr, val in list(vars(mod).items()):
                if val is orig:
                    setattr(mod, attr, recording)
                    patched.append((mod, attr))
        _every_scope()
    finally:
        for mod, attr in patched:
            setattr(mod, attr, orig)
    assert {n for n, _ in entered} == set(SCOPES)
    bad = {n for n, d in entered
           if d is None or torch.device(d).type != "cpu"}
    assert not bad, bad


def _poisoned():
    """JAX test_observability.py:100: a gradient that goes NaN beyond
    x[0] = 0.5, while the merit stays finite."""
    def f(x, p):
        return (x[0] - 2.0) ** 2 + x[1] ** 2

    def df(x, p):
        g = torch.func.grad(f)(x, p)
        return g + torch.where(x[0] > 0.5, torch.nan, 0.0)

    return make_problem(f, 2, df=df)


def test_nan_guard_and_nan_debugging():
    """The always-on guard ends the poisoned solve with signal -3 well
    before the budget, as in the JAX package; ``enable_nan_debugging``
    raises ``FloatingPointError`` there instead."""
    x0 = torch.tensor([0.0, 1.0], dtype=torch.float64)
    cfg = IPMConfig(verbosity=0, niter=30)
    res = solve(_poisoned(), x0, cfg)
    import pyipm_tpu as jp

    def jf(x):
        return (x[0] - 2.0) ** 2 + x[1] ** 2

    jres = jp.solve(jp.make_problem(
        jf, nvar=2, df=lambda x: jax.grad(jf)(x)
        + jnp.where(x[0] > 0.5, jnp.nan, 0.0)), np.array([0.0, 1.0]),
        JCfg(verbosity=0, niter=30))
    assert int(res.signal) == int(jres.signal) == -3
    assert int(res.iter_count) == int(jres.iter_count) < 30 * 20
    enable_nan_debugging()
    try:
        with pytest.raises(FloatingPointError, match="non-finite"):
            solve(_poisoned(), x0, cfg)
    finally:
        enable_nan_debugging(False)
    assert int(solve(_poisoned(), x0, cfg).signal) == -3


def test_nan_debugging_one_host_sync_per_step():
    """While on, the check costs one host sync per flat step that takes an
    inner iteration (for one instance, one per iteration), none on the
    others, and leaves the solve's result unchanged; the error names the
    field that is not finite."""
    from pyipm_tpu_torch import _sync

    def counted():
        for k in _sync.COUNTS:
            _sync.COUNTS[k] = 0
        res = solve(reference_problem(7).make(), torch.as_tensor(_x0()),
                    IPMConfig(Ftol=1e-8, verbosity=0))
        return res, dict(_sync.COUNTS)

    off, c_off = counted()
    enable_nan_debugging()
    try:
        on, c_on = counted()
        with pytest.raises(FloatingPointError,
                           match=r"non-finite (x|s|lda|kkt) "):
            solve(_poisoned(), torch.tensor([0.0, 1.0], dtype=torch.float64),
                  IPMConfig(verbosity=0, niter=30))
    finally:
        enable_nan_debugging(False)
    assert c_on["flat_steps"] == c_off["flat_steps"] > 0
    assert c_on["host_syncs"] - c_off["host_syncs"] == int(on.iter_count)
    assert int(on.iter_count) < c_on["flat_steps"]
    assert int(on.iter_count) == int(off.iter_count)
    assert torch.equal(on.x, off.x)


def test_cli_profile_writes_a_trace(tmp_path):
    """``python -m pyipm_tpu_torch 7 --profile DIR`` (in process, on the
    CPU) solves as without it and leaves a trace holding the scopes."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["7", "--device", "cpu", "--seed", "42", "--verbosity",
                  "0", "--profile", str(tmp_path)])
    assert "Distance to nearest optimum" in out.getvalue()
    (path,) = glob.glob(str(tmp_path / "*.json"))
    with open(path) as fh:
        text = fh.read()
    assert "ipm-direction" in text and "ipm-kkt-factor" in text
