"""The port's ``IPM`` facade and CLI (pyipm_tpu_torch/api.py, cli.py)
against the JAX package's (pyipm_tpu/api.py, cli.py) on the CPU, float64:
the reference 5-tuple, ``KKT()`` blocks, the report and progress lines,
the mu0/nu0 warm start, and ``python -m`` printouts line for line (numbers
to 1e-8 relative, as the two print their own float formats)."""

import contextlib
import io
import re

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from pyipm_tpu import IPM as JIPM  # noqa: E402
from pyipm_tpu import cli as jcli  # noqa: E402
from pyipm_tpu.models import REFERENCE_PROBLEMS as J_REF  # noqa: E402
from pyipm_tpu_torch import IPM  # noqa: E402
from pyipm_tpu_torch import cli  # noqa: E402
from pyipm_tpu_torch.models import REFERENCE_PROBLEMS as T_REF  # noqa: E402

NUM = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")


def _facades(num, seed=42, **kw):
    """The same problem and x0 in both facades."""
    js, ts = J_REF[num], T_REF[num]
    x0 = js.sample_x0(np.random.default_rng(seed))
    jp = JIPM(x0=x0, f=js.f, ce=js.ce, ci=js.ci, **kw)
    tp = IPM(x0=x0, f=ts.f, ce=ts.ce, ci=ts.ci, device="cpu", **kw)
    return jp, tp


def _run(fn, *args, **kw):
    """(return value, stdout) of one call."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def _same_text(got, want, rtol=1e-8, ordered=True):
    """Line for line equal, numbers compared as numbers.  ``ordered=False``
    compares the lines as sorted lists: ``jax.debug.print`` does not order
    the lines it prints within one iteration."""
    gl, wl = got.strip().splitlines(), want.strip().splitlines()
    if not ordered:
        gl, wl = sorted(gl), sorted(wl)
    assert len(gl) == len(wl), (got, want)
    for g, w in zip(gl, wl):
        assert NUM.sub("#", g) == NUM.sub("#", w), (g, w)
        gn = [float(v) for v in NUM.findall(g)]
        wn = [float(v) for v in NUM.findall(w)]
        np.testing.assert_allclose(gn, wn, rtol=rtol, atol=1e-12,
                                   err_msg=g)


def test_solve_returns_reference_tuple():
    jp, tp = _facades(7, Ftol=1e-8, verbosity=-1)
    jout, tout = jp.solve(), tp.solve()
    x, s, lda, fval, kkt = tout
    assert (x.shape, s.shape, lda.shape) == ((3,), (3,), (4,))
    assert isinstance(fval, float) and len(kkt) == 4
    assert all(isinstance(a, np.ndarray) for a in (x, s, lda, *kkt))
    for got, want in zip(tout[:3], jout[:3]):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-8)
    assert fval == pytest.approx(jout[3], rel=1e-12)
    assert tp.signal == jp.signal == 1
    np.testing.assert_array_equal(tp.x, x)
    assert tp.fval == fval
    assert T_REF[7].distance_to_truth(x) <= 1e-3


def test_kkt_blocks_match_jax():
    """Problem 10 (M = N = 1): the blocks at the solution, and at a given
    mu, equal the JAX facade's."""
    jp, tp = _facades(10, seed=0, verbosity=-1)
    jx, js, jl, _, jk = jp.solve()
    x, s, lda, _, kkt = tp.solve()
    assert [k.shape for k in kkt] == [(3,), (1,), (1,), (1,)]
    for got, want in zip(kkt, jk):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-8)
    for got, want in zip(tp.KKT(jx, js, jl, mu=0.3),
                         jp.KKT(jx, js, jl, mu=0.3)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12,
                                   atol=1e-14)


def test_kkt_absent_blocks_scalar_zero():
    _, tp = _facades(1, seed=0, verbosity=-1)
    x, s, lda, _, kkt = tp.solve()
    assert s.shape == (0,) and lda.shape == (0,)
    for k in kkt[1:]:
        assert k.shape == () and float(k) == 0.0


def test_kkt_default_mu_is_final_mu():
    """KKT() after a solve evaluates at the final mu (pyipm.py:968)."""
    _, tp = _facades(7, Ftol=1e-8, verbosity=-1)
    x, s, lda, _, kkt = tp.solve()
    assert tp.mu is not None and tp.mu < tp.config.mu
    for a, b in zip(tp.KKT(x, s, lda), kkt):
        np.testing.assert_array_equal(a, b)
    assert not np.allclose(tp.KKT(x, s, lda, mu=tp.config.mu)[1], kkt[1])


@pytest.mark.parametrize("num,kw", [
    (7, {}), (10, {}), (5, {"lbfgs": 4}), (7, {"linear_solver": "lu"}),
    (1, {"verbosity": 2}), (3, {"verbosity": 3}),
])
def test_printout_matches_jax(num, kw):
    """The mode banner, OUTER / INNER ITERATION or ITERATION lines, f(x) at
    verbosity 2, the KKT norms and line-search notices at 3, and the final
    report."""
    kw = {"Ftol": 1e-8, "verbosity": 1, **kw}
    jp, tp = _facades(num, **kw)
    (jx, *_), jtext = _run(jp.solve)
    (x, *_), text = _run(tp.solve)
    assert "Searching for a feasible local minimizer" in text
    assert "ITERATION" in text
    _same_text(text, jtext, ordered=kw["verbosity"] < 2)
    np.testing.assert_allclose(x, np.asarray(jx), rtol=0, atol=1e-8)


def test_mu0_nu0_warm_start_matches_jax():
    """solve(mu0=, nu0=): the reference's stateful warm start on request."""
    jp, tp = _facades(5, seed=7, Ftol=1e-8, verbosity=-1)
    jx1, *_ = jp.solve()
    x1, *_ = tp.solve()
    assert tp.mu == pytest.approx(jp.mu, rel=1e-8)
    assert tp.nu == pytest.approx(jp.nu, rel=1e-8)
    jx2, *_ = jp.solve(x0=np.asarray(jx1), mu0=jp.mu, nu0=jp.nu)
    x2, *_ = tp.solve(x0=x1, mu0=tp.mu, nu0=tp.nu)
    assert tp.signal == jp.signal and tp.signal in (1, 2)
    np.testing.assert_allclose(x2, np.asarray(jx2), rtol=0, atol=1e-8)
    assert T_REF[5].distance_to_truth(x2) <= 1e-3
    # the overrides are used: a larger initial barrier moves the result
    x3, *_ = tp.solve(x0=x1, mu0=100 * tp.mu, nu0=tp.nu)
    assert not np.array_equal(x3, x2)


def test_new_x0_of_another_size_rebuilds():
    tp = IPM(f=lambda x, p: torch.sum((x - 1.0) ** 2), verbosity=-1,
             device="cpu")
    x2, *_ = tp.solve(x0=np.zeros(2))
    x3, *_ = tp.solve(x0=np.zeros(3))
    assert x2.shape == (2,)
    np.testing.assert_allclose(x3, np.ones(3), atol=1e-6)


def test_validation_raises():
    with pytest.raises(ValueError, match="dce"):
        IPM(x0=np.zeros(2), f=lambda x, p: x @ x,
            dce=lambda x, p: torch.zeros(2, 1), device="cpu").solve()
    with pytest.raises(ValueError, match="objective"):
        IPM(x0=np.zeros(2), device="cpu").solve()


def test_the_card_by_default(monkeypatch):
    """With no card the facade and the CLI raise unless told the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = T_REF[7]
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            IPM(x0=np.ones(3) / 3, f=spec.f, device=device)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run(cli.main, ["7", "--seed", "42"])
    assert IPM(x0=np.ones(3) / 3, f=spec.f,
               device="cpu").device.type == "cpu"


@pytest.mark.parametrize("argv", [
    ["7", "--seed", "42"],
    ["10", "--seed", "1", "--lbfgs", "4", "--verbosity", "2"],
])
def test_cli_printout_matches_jax(argv):
    """``python -m pyipm_tpu_torch ... --device cpu`` against
    ``python -m pyipm_tpu ...``, line for line."""
    _, want = _run(jcli.main, argv)
    _, got = _run(cli.main, argv + ["--device", "cpu"])
    _same_text(got, want)
    assert "Converged to Ktol tolerance" in got


def test_cli_profile_names_the_roadmap(tmp_path):
    """``--profile LOGDIR`` is ported: the solve prints as without it and
    writes a trace into LOGDIR."""
    _, got = _run(cli.main, ["7", "--seed", "42", "--device", "cpu",
                             "--profile", str(tmp_path)])
    _, want = _run(cli.main, ["7", "--seed", "42", "--device", "cpu"])
    _same_text(got, want)
    assert len(list(tmp_path.glob("*.json"))) == 1
    with pytest.raises(SystemExit):
        _run(cli.main, ["11", "--device", "cpu"])


def test_fleets_print_nothing():
    """solve_batch prints nothing at any verbosity; a single solve prints."""
    from pyipm_tpu_torch import IPMConfig, solve, solve_batch

    prob = T_REF[7].make()
    x0 = torch.as_tensor(np.array([[0.2, 0.5, 0.3], [0.3, 0.3, 0.4]]))
    cfg = IPMConfig(Ftol=1e-8, verbosity=3)
    _, text = _run(solve_batch, prob, x0, cfg)
    assert text == ""
    _, text = _run(solve, prob, x0[0], cfg)
    assert "INNER ITERATION" in text and "|dL/dx|" in text


def test_constraint_counts_match_jax():
    """The constraint counts come from one call on a zero x, as the JAX
    facade's from eval_shape."""
    js, ts = J_REF[8], T_REF[8]
    jp = JIPM(x0=np.zeros(3), f=js.f, ce=js.ce, verbosity=-1)
    tp = IPM(x0=np.zeros(3), f=ts.f, ce=ts.ce, verbosity=-1, device="cpu")
    jp.compile()
    tp.compile()
    assert (tp.nvar, tp.neq, tp.nineq) == (jp.nvar, jp.neq, jp.nineq)
