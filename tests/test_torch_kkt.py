"""The port's problem derivatives and KKT pieces (pyipm_tpu_torch/core)
against the JAX package's, at fixed numpy-seeded iterates, in float64 to
1e-12: on the random QP family and on reference example 7 (M > 0)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pyipm_tpu.core import kkt as JK  # noqa: E402
from pyipm_tpu.models.random_nlp import QPData as JQP  # noqa: E402
from pyipm_tpu.models.random_nlp import make_qp_problem as j_qp  # noqa: E402
from pyipm_tpu.models.reference_problems import (  # noqa: E402
    REFERENCE_PROBLEMS as J_REF,
)
from pyipm_tpu_torch.core import kkt as TK  # noqa: E402
from pyipm_tpu_torch.core.updates import centrality_mu  # noqa: E402
from pyipm_tpu_torch.models.random_nlp import (  # noqa: E402
    make_qp_problem as t_qp, qp_data, sample_qp_arrays,
)
from pyipm_tpu_torch.models.reference_problems import (  # noqa: E402
    REFERENCE_PROBLEMS as T_REF,
)

KTOL = 1e-4
B, D, NLIN = 4, 5, 3

# name -> (jax fn(problem, x, s, lda, mu, nu, dz), torch fn(... , p))
QUANTITIES = {
    "grad_f": (lambda P, x, s, l, mu, nu, dz: P.grad_f(x),
               lambda P, x, s, l, mu, nu, dz, p: P.grad_f(x, p)),
    "jac_ci": (lambda P, x, s, l, mu, nu, dz: P.jac_ci(x),
               lambda P, x, s, l, mu, nu, dz, p: P.jac_ci(x, p)),
    "hess_lagrangian": (
        lambda P, x, s, l, mu, nu, dz: P.hess_lagrangian(x, l),
        lambda P, x, s, l, mu, nu, dz, p: P.hess_lagrangian(x, l, p)),
    "con": (lambda P, x, s, l, mu, nu, dz: JK.con(P, x, s),
            lambda P, x, s, l, mu, nu, dz, p: TK.con(P, x, s, p)),
    "jaco": (lambda P, x, s, l, mu, nu, dz: JK.jaco(P, x),
             lambda P, x, s, l, mu, nu, dz, p: TK.jaco(P, x, p)),
    "grad": (lambda P, x, s, l, mu, nu, dz: JK.grad(P, x, s, l, mu),
             lambda P, x, s, l, mu, nu, dz, p: TK.grad(P, x, s, l, mu, p)),
    "kkt_norms": (
        lambda P, x, s, l, mu, nu, dz: JK.kkt_norms(P, x, s, l, mu),
        lambda P, x, s, l, mu, nu, dz, p: TK.kkt_norms(P, x, s, l, mu, p)),
    "phi": (lambda P, x, s, l, mu, nu, dz: JK.phi(P, x, s, mu, nu),
            lambda P, x, s, l, mu, nu, dz, p: TK.phi(P, x, s, mu, nu, p)),
    "dphi": (lambda P, x, s, l, mu, nu, dz: JK.dphi(P, x, s, dz, mu, nu),
             lambda P, x, s, l, mu, nu, dz, p: TK.dphi(P, x, s, dz, mu, nu,
                                                       p)),
    "barrier_cost_grad": (
        lambda P, x, s, l, mu, nu, dz: JK.barrier_cost_grad(P, x, s, mu),
        lambda P, x, s, l, mu, nu, dz, p: TK.barrier_cost_grad(P, x, s, mu,
                                                               p)),
    "init_slack": (
        lambda P, x, s, l, mu, nu, dz: JK.init_slack(P, x, KTOL),
        lambda P, x, s, l, mu, nu, dz, p: TK.init_slack(P, x, KTOL, p)),
    "init_lambda": (
        lambda P, x, s, l, mu, nu, dz: JK.init_lambda(P, x, KTOL),
        lambda P, x, s, l, mu, nu, dz, p: TK.init_lambda(P, x, KTOL, p)),
}


def _iterate(rng, nvar, neq, nineq):
    x = rng.standard_normal((B, nvar))
    s = np.abs(rng.standard_normal((B, nineq))) + 0.2
    lda = rng.standard_normal((B, neq + nineq))
    lda[:, neq:] = np.abs(lda[:, neq:]) + 0.1
    mu = np.abs(rng.standard_normal(B)) + 0.05
    nu = np.full(B, 10.0)
    dz = rng.standard_normal((B, nvar + nineq))
    return x, s, lda, mu, nu, dz


def _compare(name, jfn_batched, tprob, args, p):
    tf = QUANTITIES[name][1]
    targs = [torch.as_tensor(a) for a in args]
    got = tf(tprob, *targs, p).numpy()
    want = np.asarray(jfn_batched(*[jnp.asarray(a) for a in args]))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", sorted(QUANTITIES))
def test_qp_family_matches_jax(name):
    rng = np.random.default_rng(5)
    arr = sample_qp_arrays(11, B, D, NLIN, np.float64)
    nineq = 2 * D + NLIN
    args = _iterate(rng, D, 0, nineq)
    jdata = JQP(*(jnp.asarray(arr[k]) for k in JQP._fields))
    jf = QUANTITIES[name][0]

    def one(data, x, s, lda, mu, nu, dz):
        return jf(j_qp(data, D, NLIN), x, s, lda, mu, nu, dz)

    _compare(name, lambda *a: jax.vmap(one)(jdata, *a), t_qp(D, NLIN),
             args, qp_data(arr, device="cpu"))


@pytest.mark.parametrize("name", sorted(set(QUANTITIES) - {"jac_ci"})
                         + ["jac_ce"])
def test_example7_matches_jax(name):
    rng = np.random.default_rng(7)
    jprob = J_REF[7].make()
    tprob = T_REF[7].make()
    assert (tprob.neq, tprob.nineq) == (jprob.neq, jprob.nineq) == (1, 3)
    args = _iterate(rng, 3, 1, 3)
    if name == "jac_ce":
        got = tprob.jac_ce(torch.as_tensor(args[0]), ()).numpy()
        want = np.asarray(jax.vmap(jprob.jac_ce)(jnp.asarray(args[0])))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
        return
    jf = QUANTITIES[name][0]
    _compare(name, jax.vmap(lambda *a: jf(jprob, *a)), tprob, args, ())


def test_centrality_mu_matches_jax():
    from pyipm_tpu.core.updates import centrality_mu as j_cmu

    rng = np.random.default_rng(3)
    s = np.abs(rng.standard_normal((6, 9))) + 1e-3
    li = np.abs(rng.standard_normal((6, 9))) + 1e-3
    sl, smin = np.sum(s * li, -1), np.min(s * li, -1)
    eps = float(np.finfo(np.float64).eps)
    got = centrality_mu(torch.as_tensor(sl), torch.as_tensor(smin), 9, eps,
                        eps).numpy()
    want = np.asarray(jax.vmap(lambda a, b: j_cmu(a, b, 9, eps, eps,
                                                  jnp.float64))(sl, smin))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def _t7_overrides():
    """All six derivative overrides of example 7, written by hand in the
    reference's conventions (transposed D x M / D x N Jacobians,
    multiplier-contracted constraint Hessians over the FULL lambda)."""
    def df(x, p):
        return -torch.stack([x[1] * x[2], x[0] * x[2], x[0] * x[1]])

    def d2f(x, p):
        z = torch.zeros((), dtype=x.dtype)
        return -torch.stack([torch.stack([z, x[2], x[1]]),
                             torch.stack([x[2], z, x[0]]),
                             torch.stack([x[1], x[0], z])])

    return dict(
        df=df, d2f=d2f,
        dce=lambda x, p: torch.ones((3, 1), dtype=x.dtype),
        d2ce=lambda x, lda, p: torch.zeros((3, 3), dtype=x.dtype),
        dci=lambda x, p: torch.eye(3, dtype=x.dtype),
        d2ci=lambda x, lda, p: torch.zeros((3, 3), dtype=x.dtype))


@pytest.mark.parametrize("supplied", [("df", "d2f"), ("dce", "d2ce"),
                                      ("dci", "d2ci")])
def test_derivative_overrides_match_jax_autodiff(supplied):
    """User-supplied derivatives go through the same slots as autodiff:
    the Lagrangian gradient and Hessian match the JAX package's."""
    from pyipm_tpu_torch.core.problem import make_problem

    spec = T_REF[7]
    ov = {k: v for k, v in _t7_overrides().items() if k in supplied}
    tprob = make_problem(spec.f, 3, ce=spec.ce, ci=spec.ci, **ov)
    jprob = J_REF[7].make()
    args = _iterate(np.random.default_rng(9), 3, 1, 3)
    for name in ("grad", "hess_lagrangian", "jaco"):
        jf = QUANTITIES[name][0]
        _compare(name, jax.vmap(lambda *a: jf(jprob, *a)), tprob, args, ())
