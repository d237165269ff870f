"""The port's batched KKT solve at K > 128 (the batch-first body of
``pyipm_tpu_torch/ops/linalg.py``: kernel 3 on the batch of diagonal
panels, batched triangular solves on the padded factors, the escalation and
the residual gate over the instances still looping) against the JAX
package's ``vmap`` of ``reg_solve_kkt``, against the port's own
single-system path, and a fleet of portfolios wider than 128 assets through
both packages' batched solvers.  float64 on the CPU unless stated.

One batch holds the four systems of ``test_torch_large_ldlt.CASES``
(healthy, wrong inertia, warm-started, a rank-deficient eq block), so every
per-instance decision differs across it.  Tolerances: retries equal,
delta_new and the applied shifts to 1e-12, dz and a further solve through
the final factors to 1e-10 relative; the rank-deficient instance, whose
system is regularized by ~6e-13 only, by a backward error of 1e-12 against
the regularized system (as the single-system test holds it)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pyipm_tpu import IPMConfig as JCfg  # noqa: E402
from pyipm_tpu.models import applications as japp  # noqa: E402
from pyipm_tpu.ops import linalg as JL  # noqa: E402
from pyipm_tpu_torch import IPMConfig, _sync, interop  # noqa: E402
from pyipm_tpu_torch.models import applications as app  # noqa: E402
from pyipm_tpu_torch.ops import linalg as TL  # noqa: E402
from test_torch_large_ldlt import CASES, _bkw, _rel, _saddle  # noqa: E402

M = 16
NAMES = sorted(CASES)
RANK_DEF = NAMES.index("rank_deficient_je")


def _kw():
    cfg = JCfg(float_dtype="float64")
    return dict(eps=cfg.eps, reg_coef=cfg.reg_coef, eta=cfg.eta,
                beta=cfg.beta, delta0=cfg.delta0, max_retries=40)


def _batch(K, seed=0, names=NAMES):
    """(H, g, delta, rhs2) of one system per case name, float64 numpy."""
    rng = np.random.default_rng(seed)
    Hs, deltas = [], []
    for name in names:
        spec = dict(CASES[name])
        deltas.append(spec.pop("delta", 0.0))
        Hs.append(_saddle(rng, K - M, M, **spec))
    B = len(names)
    g = rng.standard_normal((B, K))
    rhs2 = np.cos(np.arange(B * K).reshape(B, K) + 1.0)
    return np.stack(Hs), g, np.asarray(deltas), rhs2


def _port(H, g, delta, rhs2, want_solver):
    """The port's call; with ``want_solver`` the further solve of rhs2 and
    the applied shifts appended: (dz, delta_new, retries[, x2, d_app,
    e_app]) as numpy."""
    D = H.shape[-1] - M
    B = H.shape[0]
    out = TL.reg_solve_kkt(torch.as_tensor(H), torch.as_tensor(g),
                           torch.as_tensor(delta),
                           torch.full((B,), 0.1, dtype=torch.float64),
                           nvar=D, neq=M, nineq=0, want_solver=want_solver,
                           **_kw())
    got = list(out[:3])
    if want_solver:
        got += [out[3](torch.as_tensor(rhs2)), *out[4]]
    return [t.numpy() for t in got]


def _jax(H, g, delta, rhs2, want_solver):
    """``jax.jit(jax.vmap(reg_solve_kkt))`` on the same batch, in the same
    layout as :func:`_port`."""
    D = H.shape[-1] - M

    def one(H_, g_, dl_, r_):
        out = JL.reg_solve_kkt(H_, g_, dl_, jnp.asarray(0.1), method="ldlt",
                               nvar=D, neq=M, nineq=0,
                               want_solver=want_solver, **_kw())
        if want_solver:
            return out[:3] + (out[3](r_),) + tuple(out[4])
        return out

    want = jax.jit(jax.vmap(one))(*(jnp.asarray(a) for a in
                                    (H, g, delta, rhs2)))
    return [np.asarray(w) for w in want]


def _hold(got, want, H, g, want_solver, dz_rtol=1e-10):
    """Per instance: retries equal, delta_new and the applied shifts to
    1e-12, dz and the further solve to ``dz_rtol``; the rank-deficient
    instance by its backward error (with ``want_solver``, which returns the
    shifts it needs)."""
    D = H.shape[-1] - M
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-12)
    if want_solver:
        np.testing.assert_allclose(got[4], want[4], rtol=1e-12)
        np.testing.assert_allclose(got[5], want[5], rtol=1e-12)
    for i in range(H.shape[0]):
        if i == RANK_DEF:
            assert float(want[1][i]) > 0.0                   # escalated
            if want_solver:
                assert float(want[5][i]) > 0.0               # eq shift
                for dz in (got[0][i], want[0][i]):
                    assert _bkw(H[i], dz, g[i], want[4][i], want[5][i],
                                D) < 1e-12
            continue
        assert _rel(got[0][i], want[0][i]) < dz_rtol, i
        if want_solver:
            assert _rel(got[3][i], want[3][i]) < dz_rtol, i


@pytest.mark.parametrize("want_solver", [False, True])
@pytest.mark.parametrize("K", [144, 216])
def test_reg_solve_kkt_wide_batch_matches_jax_vmap(K, want_solver):
    H, g, delta, rhs2 = _batch(K)
    got = _port(H, g, delta, rhs2, want_solver)
    want = _jax(H, g, delta, rhs2, want_solver)
    _hold(got, want, H, g, want_solver)
    assert int(want[2][NAMES.index("wrong_inertia")]) > 0
    assert float(want[1][NAMES.index("healthy")]) == 0.0


@pytest.mark.parametrize("want_solver", [False, True])
def test_reg_solve_kkt_wide_batch_matches_single_path(want_solver):
    """Each instance of the batch against its own B = 1 call (the
    single-system path: folded forward substitution, the backward sweep,
    superblock or panel inverses)."""
    H, g, delta, rhs2 = _batch(216, seed=1)
    got = _port(H, g, delta, rhs2, want_solver)
    ones = [_port(H[i:i + 1], g[i:i + 1], delta[i:i + 1], rhs2[i:i + 1],
                  want_solver) for i in range(H.shape[0])]
    want = [np.concatenate([o[j] for o in ones])
            for j in range(len(ones[0]))]
    _hold(got, want, H, g, want_solver)


def test_reg_solve_kkt_wide_batch_syncs_do_not_grow_with_b():
    """One call's host syncs at B = 2 and at B = 8 (the same two systems
    four times over, so the same escalation depth): equal, so the batch
    is not looped over."""
    H, g, delta, rhs2 = _batch(216, names=("healthy", "wrong_inertia"))
    syncs, retries = [], []
    for reps in (1, 4):
        _sync.COUNTS["host_syncs"] = 0
        out = _port(*(np.concatenate([a] * reps) for a in
                      (H, g, delta, rhs2)), True)
        syncs.append(_sync.COUNTS["host_syncs"])
        retries.append(out[2])
    np.testing.assert_array_equal(retries[1], np.tile(retries[0], 4))
    assert retries[0][1] > 0                         # it escalated
    assert syncs[0] == syncs[1], syncs


@pytest.mark.parametrize("want_solver", [False, True])
def test_wide_batch_gate_fires_on_the_port_path(want_solver, monkeypatch):
    """The residual gate at K > 128 on the port's own factor and solves.
    Both packages' first factorization of the call (and only that one) gets
    its first pivot doubled, so the instances that keep it (no escalation)
    solve with a backward error far above sqrt(eps) and the gate must
    refactor them at 10 delta0; the escalated ones never see the doubled
    pivot.  delta_new, retries and the direction are held to the JAX
    package's vmapped path."""
    first = []

    def first_pivot_doubled(d, double):
        first.append(1)
        return double(d) if len(first) == 1 else d

    factor = TL.ldlt_factor_batched

    def port_factor(Hm, **k):
        L, d = factor(Hm, **k)
        return L, first_pivot_doubled(
            d, lambda d_: torch.cat([2 * d_[:, :1], d_[:, 1:]], dim=1))

    def jax_factor(fn):
        def wrapped(Hm, **k):
            out = fn(Hm, **k)
            d = first_pivot_doubled(out[1], lambda d_: d_.at[0].multiply(2))
            return (out[0], d) + tuple(out[2:])
        return wrapped

    H, g, delta, rhs2 = _batch(144, seed=2)
    monkeypatch.setattr(TL, "ldlt_factor_batched", port_factor)
    got = _port(H, g, delta, rhs2, want_solver)
    first.clear()
    name = "ldlt_factor_blocks" if want_solver else "ldlt_factor_panels"
    monkeypatch.setattr(JL, name, jax_factor(getattr(JL, name)))
    want = _jax(H, g, delta, rhs2, want_solver)
    _hold(got, want, H, g, want_solver)
    kept = [NAMES.index(n) for n in ("healthy", "warm_started")]
    delta0 = JCfg(float_dtype="float64").delta0
    np.testing.assert_allclose(got[1][kept], 10 * delta0, rtol=1e-12)
    np.testing.assert_array_equal(got[2][kept], 1)


# ----------------------------------------------------------------------
# a fleet of portfolios wider than 128 assets: K = D + 1 = 161
NASSETS = 160


def _fleet(dtype):
    arr = app.sample_portfolio_arrays(42, 4, NASSETS, np.dtype(dtype))
    x0 = app.portfolio_x0(4, NASSETS, np.dtype(dtype), "cpu")
    port = app.BatchSolver(app.make_portfolio_problem(NASSETS), IPMConfig(
        float_dtype=dtype, verbosity=0))(
            x0, interop.portfolio_data_from_numpy(arr, device="cpu"))
    jdata = japp.PortfolioData(*(jnp.asarray(arr[k])
                                 for k in japp.PortfolioData._fields))
    jres = japp.make_portfolio_batch_solver(
        JCfg(float_dtype=dtype, verbosity=0), NASSETS)(
            jnp.asarray(x0.numpy()), jdata)
    return port, jres


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_portfolio_wide_fleet_matches_jax(dtype):
    """``sample_portfolio_arrays(42, 4, 160)`` through the port's
    ``BatchSolver`` and the JAX package's ``make_portfolio_batch_solver``
    (its condensed systems of K = 161 take both packages' batched large
    path).  float64: signals and iterations equal, x within 1e-8.
    float32: signals equal, iterations on at least 3 of 4, x within 2e-3
    (1 + |x|)."""
    port, jres = _fleet(dtype)
    sig = port.signal.numpy()
    np.testing.assert_array_equal(sig, np.asarray(jres.signal))
    assert np.all(np.isin(sig, (1, 2))), sig
    its, jits = port.iter_count.numpy(), np.asarray(jres.iter_count)
    x, jx = port.x.numpy(), np.asarray(jres.x)
    if dtype == "float64":
        np.testing.assert_array_equal(its, jits)
        np.testing.assert_allclose(x, jx, rtol=0, atol=1e-8)
    else:
        assert int(np.sum(its == jits)) >= 3, (its, jits)
        assert float((np.abs(x - jx) / (1 + np.abs(jx))).max()) <= 2e-3


def _hess_family(family, B):
    """(problem, x, lda, data) of ``family`` at batch B: the portfolio
    family of D = 60, or the dense NLP of ``test_torch_dense_nlp`` (D =
    200, M = 16, 32 features)."""
    from pyipm_tpu_torch.models import random_nlp
    rng = np.random.default_rng(0)
    if family == "portfolio":
        D = 60
        arr = app.sample_portfolio_arrays(3, B, D, np.float64)
        data = interop.portfolio_data_from_numpy(arr, device="cpu")
        prob = app.make_portfolio_problem(D)
        x = app.portfolio_x0(B, D, np.float64, "cpu") + 1e-3 * torch.as_tensor(
            rng.standard_normal((B, D)))
    else:
        D, neq = 200, 16
        arr = random_nlp.sample_dense_arrays(0, D, neq, 32, np.float64)
        one = interop.dense_from_numpy(arr, device="cpu")
        data = type(one)(*(t.unsqueeze(0).expand(B, *t.shape)
                           for t in one))
        prob = random_nlp.make_dense_nlp_problem(D, neq)
        x = 0.3 * torch.as_tensor(rng.standard_normal((B, D)))
    lda = torch.as_tensor(np.random.default_rng(1).random(
        (B, prob.neq + prob.nineq)))
    return prob, x, lda, data


@pytest.mark.parametrize("family,B", [("portfolio", 10), ("dense", 1)])
def test_hessians_past_the_copy_budget_match_hessian(monkeypatch, family, B):
    """Past HESS_COPY_BYTES (phase 26's 500 assets: 477 GiB of copies
    under ``hessian``; one dense NLP of D = 4,096 in float64: 512 GiB of
    re-reads of P) the autodiff Hessians are taken forward over ``grad``:
    the same bits as ``hessian``, on a fleet of portfolios and on one
    dense NLP.  Under the budget the route stays ``hessian``, and
    ``_sync.COUNTS`` counts each call's route."""
    from pyipm_tpu_torch.core import problem as P
    prob, x, lda, data = _hess_family(family, B)
    D = prob.nvar

    def every_term():
        out = [prob.hess_f(x, data)]
        if prob.neq:
            out.append(prob.hess_ce(x, lda, data))
        if prob.nineq:
            out.append(prob.hess_ci(x, lda, data))
        return out

    calls = []
    for name in ("hessian", "grad"):
        fn = getattr(P, name)
        monkeypatch.setattr(P, name, lambda f, fn=fn, name=name: (
            calls.append(name), fn(f))[1])
    for k in _sync.COUNTS:
        monkeypatch.setitem(_sync.COUNTS, k, 0)
    whole = every_term()
    n = len(whole)
    assert calls == ["hessian"] * n
    assert (_sync.COUNTS["hess_hessian"], _sync.COUNTS["hess_over_grad"]) \
        == (n, 0)
    monkeypatch.setattr(P, "HESS_COPY_BYTES", B * D ** 3 * 8 - 1)
    past = every_term()
    assert calls[n:] == ["grad"] * n
    assert (_sync.COUNTS["hess_hessian"], _sync.COUNTS["hess_over_grad"]) \
        == (n, n)
    for a, b in zip(whole, past):
        assert a.shape == (B, D, D)
        assert _rel(b.numpy(), a.numpy()) <= 1e-12 and torch.equal(a, b)


def test_one_instance_hessian_past_the_budget_has_no_tangent_batched_matvec(
        monkeypatch):
    """At B = 1 past HESS_COPY_BYTES, ``hess_lagrangian`` of the dense NLP
    computes no matrix product whose batch is the D tangents with a trailing
    dimension of 1: ``hessian``'s one matrix-vector product a tangent over
    the unbatched P (a GEMV that re-reads P D times), which the same
    recorder finds under the budget."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from pyipm_tpu_torch.core import problem as P
    prob, x, lda, data = _hess_family("dense", 1)
    D = prob.nvar

    class Products(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.shapes = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket in (torch.ops.aten.bmm,
                                       torch.ops.aten.baddbmm,
                                       torch.ops.aten.mm,
                                       torch.ops.aten.mv):
                self.shapes.append([tuple(a.shape) for a in args
                                    if isinstance(a, torch.Tensor)])
            return func(*args, **(kwargs or {}))

    def tangent_matvecs():
        with Products() as rec:
            H = prob.hess_lagrangian(x, lda, data)
        return H, [s for s in rec.shapes
                   if len(s[-1]) == 3 and s[-1][0] == D and s[-1][2] == 1]

    below, found = tangent_matvecs()
    assert found, "the recorder misses hessian's tangent-batched products"
    monkeypatch.setattr(P, "HESS_COPY_BYTES", D ** 3 * 8 - 1)
    past, found = tangent_matvecs()
    assert found == []
    assert torch.equal(below, past)
