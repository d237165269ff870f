"""The Mehrotra predictor-corrector (``mu_strategy='mehrotra'``) of the
port against the JAX package on the CPU, float64: the direction as a pure
function on the same iterate (to 1e-10 relative), whole solves of the
inequality-constrained reference problems and of a QP fleet (the same
signal and iteration count, x within 1e-8), the resolution of 'auto', and
the iteration advantage over 'adaptive' on the QP family
(test_mehrotra.py:36)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pyipm_tpu import IPMConfig as JCfg  # noqa: E402
from pyipm_tpu.core.solver import make_solver as j_make_solver  # noqa: E402
from pyipm_tpu.models import REFERENCE_PROBLEMS as J_REF  # noqa: E402
from pyipm_tpu.models import random_nlp as JR  # noqa: E402
from pyipm_tpu.ops.condensed import (  # noqa: E402
    condensed_direction_mehrotra as j_mehrotra,
)
from pyipm_tpu_torch import IPMConfig, solve, solve_batch  # noqa: E402
from pyipm_tpu_torch.interop import (  # noqa: E402
    config_from_dict, qpdata_from_numpy, result_to_numpy,
)
from pyipm_tpu_torch.models import REFERENCE_PROBLEMS as T_REF  # noqa: E402
from pyipm_tpu_torch.models.random_nlp import (  # noqa: E402
    make_qp_problem, sample_qp_arrays,
)
from pyipm_tpu_torch.ops.condensed import (  # noqa: E402
    condensed_direction_mehrotra,
)

INEQ_PROBLEMS = (5, 6, 7, 9, 10)
MEH = dict(Ftol=1e-8, verbosity=0, mu_strategy="mehrotra")


def _x0(num):
    return J_REF[num].sample_x0(np.random.default_rng(42))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _interior(rng, D, M, N):
    x = 0.3 * rng.standard_normal(D)
    s = np.abs(rng.standard_normal(N)) + 0.2
    lda = rng.standard_normal(M + N)
    lda[M:] = np.abs(lda[M:]) + 0.1
    return x, s, lda


def _directions(jfn, tprob, x, s, lda, mu, delta, params=()):
    """The Mehrotra direction of both packages at one iterate; ``jfn`` is
    the JAX package's, jitted for the problem."""
    cfg = config_from_dict(dataclasses.asdict(JCfg(verbosity=0)))
    jout = jfn(*(jnp.asarray(a) for a in (x, s, lda, mu, delta)))
    T = (lambda a: torch.as_tensor(np.array(a, np.float64))[None])
    tout = condensed_direction_mehrotra(
        tprob, cfg, T(x), T(s), T(lda), T(mu), T(delta), cfg.mu_floor,
        params)
    return jout, [t[0] for t in tout]


@pytest.mark.parametrize("case", ["qp", "p10", "p6"])
def test_mehrotra_direction_matches_jax(case):
    """dz, mu_new, delta_new and retries of one predictor-corrector step,
    on a QP instance (N only), problem 10 (M and N) and problem 6 (M = 1,
    N = 6), from a random interior iterate."""
    rng = np.random.default_rng(11)
    if case == "qp":
        D, L = 8, 3
        arr = sample_qp_arrays(2, 1, D, L, np.float64)
        jprob = JR.make_qp_problem(
            JR.QPData(*(jnp.asarray(arr[k][0]) for k in JR.QPData._fields)),
            D, L)
        tprob = make_qp_problem(D, L)
        params = qpdata_from_numpy(arr, device="cpu")
        M, N = 0, 2 * D + L
    else:
        num = int(case[1:])
        jprob, tprob, params = J_REF[num].make(), T_REF[num].make(), ()
        D, M, N = tprob.nvar, tprob.neq, tprob.nineq
    x, s, lda = _interior(rng, D, M, N)
    if case == "p6":
        x = np.abs(x) + 0.05                       # log(x) needs x > 0
    jcfg = JCfg(verbosity=0)
    jfn = jax.jit(lambda *a: j_mehrotra(jprob, jcfg, *a, jcfg.mu_floor))
    for mu, delta in ((0.1, 0.0), (1e-3, 1e-4)):
        jout, tout = _directions(jfn, tprob, x, s, lda, mu, delta, params)
        for got, want, what in zip(tout, jout, ("dz", "mu_new", "delta_new")):
            assert _rel(got.numpy(), want) <= 1e-10, what
        assert int(tout[3]) == int(jout[3])


@pytest.mark.parametrize("num", INEQ_PROBLEMS)
def test_mehrotra_matches_jax_reference_problems(num):
    x0 = _x0(num)
    jr = j_make_solver(J_REF[num].make(), JCfg(**MEH))(jnp.asarray(x0))
    tr = solve(T_REF[num].make(), torch.as_tensor(x0), IPMConfig(**MEH))
    assert int(tr.signal) == int(jr.signal) and int(tr.signal) in (1, 2)
    assert int(tr.iter_count) == int(jr.iter_count)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(float(tr.mu), float(jr.mu), rtol=1e-8)
    assert T_REF[num].distance_to_truth(tr.x.numpy()) <= 1e-3


def test_mehrotra_fleet_matches_jax_per_instance():
    """A fleet whose instances finish at different steps: per instance the
    JAX package's vmapped solve."""
    B, D, L = 8, 8, 4
    arr = sample_qp_arrays(0, B, D, L, np.float64)
    x0 = np.zeros((B, D))
    jcfg = JCfg(verbosity=0, mu_strategy="mehrotra")
    jdata = JR.QPData(*(jnp.asarray(arr[k]) for k in JR.QPData._fields))
    jr = JR.make_qp_batch_solver(jcfg, D, L)(jnp.asarray(x0), jdata)
    got = result_to_numpy(solve_batch(
        make_qp_problem(D, L), torch.as_tensor(x0),
        config_from_dict(dataclasses.asdict(jcfg)),
        params=qpdata_from_numpy(arr, device="cpu")))
    np.testing.assert_array_equal(got["signal"], np.asarray(jr.signal))
    np.testing.assert_array_equal(got["iter_count"], np.asarray(jr.iter_count))
    assert len(set(got["iter_count"].tolist())) > 1
    np.testing.assert_allclose(got["x"], np.asarray(jr.x), rtol=0, atol=1e-8)


def test_auto_resolves_per_problem():
    """'auto' is Mehrotra where it applies (inequalities, exact Hessian,
    'condensed'), else 'adaptive', as the JAX package resolves it; end to
    end it solves problem 5 as 'mehrotra' does, and problem 4 (no
    inequalities) as 'adaptive' does."""
    cfg, jcfg = IPMConfig(mu_strategy="auto"), JCfg(mu_strategy="auto")
    for kw in ({}, {"lbfgs": 4}, {"linear_solver": "ldlt"},
               {"linear_solver": "lu"}):
        for n in (0, 4):
            assert (cfg.replace(**kw).resolve_mu_strategy(n).mu_strategy
                    == jcfg.replace(**kw).resolve_mu_strategy(n).mu_strategy)
    for num, twin in ((5, "mehrotra"), (4, "adaptive")):
        x0 = torch.as_tensor(_x0(num))
        auto = solve(T_REF[num].make(), x0,
                     IPMConfig(verbosity=0, mu_strategy="auto"))
        other = solve(T_REF[num].make(), x0,
                      IPMConfig(verbosity=0, mu_strategy=twin))
        assert int(auto.iter_count) == int(other.iter_count)
        assert torch.equal(auto.x, other.x)


def test_mehrotra_iteration_advantage():
    """On the QP family (B = 96, D = 8, L = 3, float32) the
    predictor-corrector needs at most 0.75x the adaptive rule's mean
    iterations at an equal or better hit rate (test_mehrotra.py:36)."""
    B, D, L = 96, 8, 3
    params = qpdata_from_numpy(sample_qp_arrays(5, B, D, L), device="cpu")
    stats = {}
    for strat in ("adaptive", "mehrotra"):
        r = solve_batch(make_qp_problem(D, L), torch.zeros((B, D)),
                        IPMConfig(float_dtype="float32", verbosity=0,
                                  mu_strategy=strat), params=params)
        sig = r.signal.numpy()
        stats[strat] = (float(np.mean(np.isin(sig, (1, 2)))),
                        float(r.iter_count.double().mean()))
    (hit_a, it_a), (hit_m, it_m) = stats["adaptive"], stats["mehrotra"]
    assert hit_m >= hit_a
    assert it_m <= 0.75 * it_a, stats


def test_mehrotra_config_validation():
    for kw in (dict(lbfgs=4), dict(linear_solver="ldlt"),
               dict(linear_solver="lu")):
        with pytest.raises(ValueError):
            IPMConfig(mu_strategy="mehrotra", **kw)
    with pytest.raises(ValueError):
        IPMConfig(mu_strategy="nonsense")
