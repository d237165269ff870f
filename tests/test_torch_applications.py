"""The four application families of the port
(``pyipm_tpu_torch.models.applications``: portfolio, SVM dual, maximum
entropy, MPC) against the JAX package's, on the CPU, at the sizes of the
JAX package's test_applications.py (B = 4).

Tolerances: the callables f, ce and ci on the same numpy data and points
(float64) within 1e-12; the batched solves of both packages in float32:
every instance converged in both, iteration counts equal on at least 3 of
4, x within 2e-3; and the structural checks of test_applications.py:20-97
(feasibility to 2e-3, KKT <= Ktol at signal 1, the family's optimality
check)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pyipm_tpu import IPMConfig as JCfg  # noqa: E402
from pyipm_tpu.models import applications as japp  # noqa: E402
from pyipm_tpu_torch import IPMConfig  # noqa: E402
from pyipm_tpu_torch import interop  # noqa: E402
from pyipm_tpu_torch.models import applications as app  # noqa: E402

B = 4
KTOL = 1e-4
CFG = dict(float_dtype="float32", verbosity=0, Ktol=KTOL)

# name: (sampler, port data, JAX data class, port problem, JAX problem,
#        size)
FAMILIES = {
    "portfolio": (lambda dt: app.sample_portfolio_arrays(0, B, 8, dt),
                  interop.portfolio_data_from_numpy, japp.PortfolioData,
                  lambda: app.make_portfolio_problem(8),
                  japp.make_portfolio_problem),
    "svm": (lambda dt: app.sample_svm_arrays(1, B, 10, dtype=dt),
            interop.svm_data_from_numpy, japp.SVMData,
            lambda: app.make_svm_problem(10), japp.make_svm_problem),
    "maxent": (lambda dt: app.sample_maxent_arrays(2, B, 12, dtype=dt),
               interop.maxent_data_from_numpy, japp.MaxEntData,
               lambda: app.make_maxent_problem(12),
               japp.make_maxent_problem),
    "maxent0": (lambda dt: dict(A=np.zeros((B, 0, 6), dt),
                                b=np.zeros((B, 0), dt)),
                interop.maxent_data_from_numpy, japp.MaxEntData,
                lambda: app.make_maxent_problem(6, 0),
                japp.make_maxent_problem),
    "mpc": (lambda dt: app.sample_mpc_arrays(3, B, dtype=dt),
            interop.mpc_data_from_numpy, japp.MPCData,
            lambda: app.make_mpc_problem(6),
            lambda d: japp.make_mpc_problem(d, 6)),
}


def _x0(name, data):
    if name == "portfolio":
        return app.portfolio_x0(B, 8, device="cpu")
    if name == "svm":
        return app.svm_x0(data)
    if name == "maxent":
        return app.maxent_x0(B, 12, device="cpu")
    if name == "maxent0":
        return app.maxent_x0(B, 6, device="cpu") + 0.01
    return app.mpc_x0(B, 6, device="cpu")


def _jax_data(cls, arr):
    return cls(*(jnp.asarray(arr[k]) for k in cls._fields))


def _row(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_callables_match_jax(name):
    sample, to_port, jcls, make, jmake = FAMILIES[name]
    arr = sample(np.float64)
    data = to_port(arr, device="cpu")
    prob = make()
    rng = np.random.default_rng(7)
    x = np.abs(rng.standard_normal((B, prob.nvar))) * 0.2 + 0.01
    xt = torch.as_tensor(x)
    jd = _jax_data(jcls, arr)
    for i in range(B):
        jp = jmake(_row(jd, i))
        assert (jp.nvar, jp.neq, jp.nineq) == (prob.nvar, prob.neq,
                                               prob.nineq)
        xi = jnp.asarray(x[i])
        np.testing.assert_allclose(prob.f_val(xt, data)[i].numpy(),
                                   np.asarray(jp.f(xi)), rtol=1e-12,
                                   atol=1e-12)
        if prob.neq:
            np.testing.assert_allclose(
                prob.ce_val(xt, data)[i].numpy(),
                np.reshape(np.asarray(jp.ce(xi)), -1), rtol=1e-12,
                atol=1e-12)
        np.testing.assert_allclose(prob.ci_val(xt, data)[i].numpy(),
                                   np.asarray(jp.ci(xi)), rtol=1e-12,
                                   atol=1e-12)


def _check_fleet(res):
    sigs = res.signal.numpy()
    assert np.all(np.isin(sigs, (1, 2))), f"signals={sigs.tolist()}"
    kkt = res.kkt.numpy()
    assert np.all(kkt[sigs == 1] <= KTOL * (1 + 1e-6))


def _structure(name, res, data, arr):
    x = res.x.numpy()
    if name == "portfolio":
        np.testing.assert_allclose(x.sum(-1), 1.0, atol=2e-3)
        assert np.all(x >= -2e-3) and np.all(x <= arr["cap"] + 2e-3)
    elif name == "svm":
        np.testing.assert_allclose((arr["y"] * x).sum(-1), 0.0, atol=2e-3)
        assert np.all(x >= -2e-3)
        assert np.all(x <= arr["C"][:, None] + 2e-3)
    elif name == "maxent":
        np.testing.assert_allclose(x.sum(-1), 1.0, atol=2e-3)
        assert np.all(x >= -1e-4)
        np.testing.assert_allclose(np.einsum("bmd,bd->bm", arr["A"], x),
                                   arr["b"], atol=5e-3)
    elif name == "maxent0":
        # only the simplex: maximum entropy is uniform
        np.testing.assert_allclose(x, 1.0 / 6, atol=1e-3)
    else:
        assert np.all(np.abs(x) <= arr["umax"][:, None] + 2e-3)
        f0 = app.make_mpc_problem(6).f_val(torch.zeros_like(res.x), data)
        assert np.all(res.fval.numpy() <= f0.numpy() + 1e-5)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_batched_solve_matches_jax(name):
    sample, to_port, jcls, make, jmake = FAMILIES[name]
    arr = sample(np.float32)
    data = to_port(arr, device="cpu")
    x0 = _x0(name, data)
    res = app.BatchSolver(make(), IPMConfig(**CFG))(x0, data)
    _check_fleet(res)
    _structure(name, res, data, arr)

    jcfg = JCfg(**CFG)
    jfn = jax.jit(jax.vmap(lambda x_, d_: japp.make_solver(
        jmake(d_), jcfg.replace(verbosity=0), jit=False)(x_)))
    jres = jfn(jnp.asarray(x0.numpy()), _jax_data(jcls, arr))
    assert np.all(np.isin(np.asarray(jres.signal), (1, 2)))
    same = int(np.sum(np.asarray(jres.iter_count)
                      == res.iter_count.numpy()))
    assert same >= 3, (res.iter_count, jres.iter_count)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=0,
                               atol=2e-3)


def test_svm_x0_is_interior_and_balanced():
    """The class-balanced start of the JAX package: y'a = 0, 0 < a < C."""
    arr = app.sample_svm_arrays(4, 6, 9, dtype=np.float64)
    a = app.svm_x0(interop.svm_data_from_numpy(arr, device="cpu")).numpy()
    want = np.asarray(japp.svm_x0(_jax_data(japp.SVMData, arr),
                                  jnp.float64))
    np.testing.assert_allclose(a, want, rtol=1e-15)
    np.testing.assert_allclose((arr["y"] * a).sum(-1), 0.0, atol=1e-15)
    assert np.all(a > 0) and np.all(a < arr["C"][:, None])
