"""The ten reference problems through the port (pyipm_tpu_torch) and the JAX
package on the same numpy-drawn x0, on the CPU.

Exact Hessian, L-BFGS(4), the 'lu' linear solver, float32, the s0/lda0
warm start and the problem-10 derivative overrides: in float64 each run
must give the JAX package's signal and iteration count, with x within
1e-8 of the JAX solution (float32: both converged, x within 5e-3 of each
other and of the truth), and land within Stol = 1e-3 of a known optimum
(the reference's oracle, unit_tests.py:51)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pyipm_tpu import IPMConfig as JCfg  # noqa: E402
from pyipm_tpu import make_problem as j_make_problem  # noqa: E402
from pyipm_tpu.core.solver import make_solver as j_make_solver  # noqa: E402
from pyipm_tpu.models import REFERENCE_PROBLEMS as J_REF  # noqa: E402
from pyipm_tpu_torch import IPMConfig, make_problem, solve  # noqa: E402
from pyipm_tpu_torch.interop import reference_problem  # noqa: E402
from pyipm_tpu_torch.models import REFERENCE_PROBLEMS as T_REF  # noqa: E402

STOL = 1.0e-3
ATOL_F64 = 1e-8
TOL_F32 = 5e-3
ALL = sorted(J_REF)


def _x0(num, seed=42):
    return J_REF[num].sample_x0(np.random.default_rng(seed))


def _both(num, x0, jprob=None, tprob=None, s0=None, lda0=None, **kw):
    """One solve in each package; returns (jax result, port result)."""
    dtype = kw.get("float_dtype", "float64")
    jprob = jprob or J_REF[num].make(dtype=np.dtype(dtype))
    tprob = tprob or T_REF[num].make()
    jcfg = JCfg(Ftol=1e-8, verbosity=0, **kw)
    cfg = IPMConfig(Ftol=1e-8, verbosity=0, **kw)
    jargs = [jnp.asarray(x0, dtype)] + [jnp.asarray(a, dtype)
                                        for a in (s0, lda0) if a is not None]
    jr = j_make_solver(jprob, jcfg, with_s0=s0 is not None,
                       with_lda0=lda0 is not None)(*jargs)
    t = (lambda a: None if a is None else torch.as_tensor(np.array(a)))
    tr = solve(tprob, t(x0), cfg, s0=t(s0), lda0=t(lda0))
    return jr, tr


def _assert_same(num, jr, tr, atol=ATOL_F64):
    assert int(tr.signal) == int(jr.signal) and int(tr.signal) in (1, 2)
    assert int(tr.iter_count) == int(jr.iter_count)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=0,
                               atol=atol)
    assert T_REF[num].distance_to_truth(tr.x.numpy()) <= STOL


def test_problem_set_matches_jax():
    """Names, sizes, optima, x0 draws, and f / ce / ci at a random point."""
    assert sorted(T_REF) == ALL
    rng = np.random.default_rng(3)
    for num in ALL:
        js, ts = J_REF[num], T_REF[num]
        assert reference_problem(num) is ts and reference_problem(js) is ts
        assert (ts.name, ts.description, ts.nvar) == (js.name, js.description,
                                                      js.nvar)
        np.testing.assert_array_equal(ts.ground_truth, js.ground_truth)
        np.testing.assert_array_equal(ts.sample_x0(np.random.default_rng(5)),
                                      js.sample_x0(np.random.default_rng(5)))
        jp, tp = js.make(), ts.make()
        assert (tp.neq, tp.nineq) == (jp.neq, jp.nineq)
        x = np.abs(rng.standard_normal(ts.nvar)) + 0.1
        X = torch.as_tensor(x)[None]
        pairs = [(tp.f_val(X, ()), jp.f_val(jnp.asarray(x)))]
        if tp.neq:
            pairs.append((tp.ce_val(X, ()), jp.ce_val(jnp.asarray(x))))
        if tp.nineq:
            pairs.append((tp.ci_val(X, ()), jp.ci_val(jnp.asarray(x))))
        for got, want in pairs:
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want),
                                       rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("num", ALL)
def test_exact_hessian_matches_jax(num):
    _assert_same(num, *_both(num, _x0(num)))


@pytest.mark.parametrize("num", ALL)
def test_lbfgs_matches_jax(num):
    _assert_same(num, *_both(num, _x0(num), lbfgs=4))


@pytest.mark.parametrize("num", [3, 7, 8, 10])
def test_lu_matches_jax(num):
    """The reference's eigenvalue-inertia flow and LU solve."""
    _assert_same(num, *_both(num, _x0(num), linear_solver="lu"))


@pytest.mark.parametrize("num", ALL)
def test_float32_matches_jax(num):
    """float32 from test_float32.py's x0 (seed 7): both converge, within
    5e-3 of each other and of the truth."""
    x0 = _x0(num, seed=7).astype(np.float32)
    jr, tr = _both(num, x0, float_dtype="float32")
    x = tr.x.numpy()
    assert tr.x.dtype == torch.float32 and np.all(np.isfinite(x))
    assert int(tr.signal) in (1, 2) and int(jr.signal) in (1, 2)
    np.testing.assert_allclose(x, np.asarray(jr.x), rtol=0, atol=TOL_F32)
    assert T_REF[num].distance_to_truth(x) <= TOL_F32


def test_warm_start_s0_lda0_matches_jax():
    """A restart from the solution with its s0/lda0 (reference pyipm.py:
    1567-1578): no more iterations than the cold solve, as the JAX
    package's."""
    jr, tr = _both(7, _x0(7))
    _assert_same(7, jr, tr)
    jr2, tr2 = _both(7, np.asarray(jr.x), s0=np.asarray(jr.s),
                     lda0=np.asarray(jr.lda))
    _assert_same(7, jr2, tr2)
    assert int(tr2.iter_count) <= int(tr.iter_count)


def _p10_overrides():
    """Problem 10's derivatives for both packages, in the reference's
    transposed-Jacobian, full-multiplier conventions."""
    js, ts = J_REF[10], T_REF[10]

    def jv(fn):
        return lambda x: jnp.reshape(jnp.asarray(fn(x)), (1,))

    def tv(fn):
        return lambda x, p: torch.reshape(fn(x, p), (1,))

    jce, jci, tce, tci = jv(js.ce), jv(js.ci), tv(ts.ce), tv(ts.ci)
    tf = torch.func
    jd = dict(
        df=jax.grad(js.f), d2f=jax.hessian(js.f),
        dce=lambda x: jax.jacfwd(jce)(x).T,
        d2ce=lambda x, lda: jax.hessian(
            lambda xx: jnp.sum(jce(xx) * lda[:1]))(x),
        dci=lambda x: jax.jacfwd(jci)(x).T,
        d2ci=lambda x, lda: jax.hessian(
            lambda xx: jnp.sum(jci(xx) * lda[1:]))(x))
    td = dict(
        df=lambda x, p: tf.grad(ts.f)(x, p),
        d2f=lambda x, p: tf.hessian(ts.f)(x, p),
        dce=lambda x, p: tf.jacfwd(tce)(x, p).T,
        d2ce=lambda x, lda, p: tf.hessian(
            lambda xx: torch.sum(tce(xx, p) * lda[:1]))(x),
        dci=lambda x, p: tf.jacfwd(tci)(x, p).T,
        d2ci=lambda x, lda, p: tf.hessian(
            lambda xx: torch.sum(tci(xx, p) * lda[1:]))(x))
    return jd, td


def p10_with(supplied):
    """Problem 10 in both packages with the derivatives ``supplied``."""
    js, ts = J_REF[10], T_REF[10]
    jd, td = _p10_overrides()
    jprob = j_make_problem(js.f, js.nvar, ce=js.ce, ci=js.ci,
                           **{k: jd[k] for k in supplied})
    tprob = make_problem(ts.f, ts.nvar, ce=ts.ce, ci=ts.ci,
                         **{k: td[k] for k in supplied})
    return jprob, tprob


@pytest.mark.parametrize("supplied", [
    (), ("df",), ("df", "d2f"), ("dce", "dci"), ("d2ce", "d2ci"),
    ("df", "d2f", "dce", "d2ce", "dci", "d2ci"),
])
def test_exact_hessian_override_combos_match_jax(supplied):
    """test_derivative_overrides.py:61 in both packages."""
    jprob, tprob = p10_with(supplied)
    _assert_same(10, *_both(10, _x0(10), jprob=jprob, tprob=tprob))


@pytest.mark.parametrize("supplied", [(), ("df",), ("df", "dce", "dci")])
def test_lbfgs_override_combos_match_jax(supplied):
    """test_derivative_overrides.py:72 in both packages: first-derivative
    overrides under L-BFGS(4)."""
    jprob, tprob = p10_with(supplied)
    _assert_same(10, *_both(10, _x0(10), jprob=jprob, tprob=tprob, lbfgs=4))
