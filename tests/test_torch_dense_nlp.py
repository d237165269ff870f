"""The dense nonconvex NLP family and the full-KKT ('ldlt') direction of
the port against the JAX package, on identical numpy-seeded data: the
problem's quantities, ``kkt_matrix`` / ``kkt_blocks``, and whole solves
at D = 200, M = 16, hidden = 32 (K = 216 > 128, the blocked path) with the
'condensed' and the 'ldlt' linear solver, float64."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pyipm_tpu import IPMConfig as JCfg  # noqa: E402
from pyipm_tpu.core import kkt as JK  # noqa: E402
from pyipm_tpu.models import random_nlp as JR  # noqa: E402
from pyipm_tpu_torch import solve, solve_batch  # noqa: E402
from pyipm_tpu_torch.core import kkt as TK  # noqa: E402
from pyipm_tpu_torch.interop import (  # noqa: E402
    config_from_dict, dense_from_numpy, qpdata_from_numpy,
)
from pyipm_tpu_torch.models.random_nlp import (  # noqa: E402
    make_dense_nlp_problem, make_qp_problem, sample_dense_arrays,
    sample_qp_arrays,
)

D, M, HID = 200, 16, 32


@pytest.fixture(scope="module")
def dense():
    arr = sample_dense_arrays(0, D, M, HID, np.float64)
    jdata = JR.DenseNLPData(*(jnp.asarray(arr[k])
                              for k in JR.DenseNLPData._fields))
    tdata = dense_from_numpy(jdata, device="cpu")
    return arr, jdata, tdata


def _batch1(data):
    return type(data)(*(t.unsqueeze(0) for t in data))


def _state(rng, n, m_con, nineq):
    x = rng.standard_normal(n) * 0.3
    s = np.abs(rng.standard_normal(nineq)) + 0.5
    lda = rng.standard_normal(m_con + nineq)
    lda[m_con:] = np.abs(lda[m_con:]) + 0.1
    return x, s, lda, 0.1


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def test_dense_data_carries_across(dense):
    arr, jdata, tdata = dense
    for k in tdata._fields:
        np.testing.assert_array_equal(getattr(tdata, k).numpy(), arr[k])
    assert tdata.P.dtype == torch.float64


def test_dense_problem_and_kkt_match_jax(dense):
    """f, gradient, Jacobian, Hessian of the Lagrangian, kkt_matrix and
    kkt_blocks at one iterate, to 1e-10 relative."""
    _, jdata, tdata = dense
    jp = JR.make_dense_nlp_problem(jdata, D, M)
    tp = make_dense_nlp_problem(D, M)
    x, s, lda, mu = _state(np.random.default_rng(1), D, M, 0)
    p = _batch1(tdata)
    X, S, LDA = (torch.as_tensor(a)[None] for a in (x, s, lda))
    MU = torch.tensor([mu], dtype=torch.float64)
    pairs = [
        (tp.f_val(X, p)[0], jp.f_val(jnp.asarray(x))),
        (tp.grad_f(X, p)[0], jp.grad_f(jnp.asarray(x))),
        (tp.jac_ce(X, p)[0], jp.jac_ce(jnp.asarray(x))),
        (tp.hess_lagrangian(X, LDA, p)[0],
         jp.hess_lagrangian(jnp.asarray(x), jnp.asarray(lda))),
        (TK.kkt_matrix(tp, X, S, LDA, MU, p)[0],
         JK.kkt_matrix(jp, *(jnp.asarray(a) for a in (x, s, lda, mu)))),
    ]
    tb = TK.kkt_blocks(tp, X, S, LDA, MU, p)
    jb = JK.kkt_blocks(jp, *(jnp.asarray(a) for a in (x, s, lda, mu)))
    pairs += [(t[0], j) for t, j in zip(tb, jb)]
    for i, (t, j) in enumerate(pairs):
        assert tuple(t.shape) == np.shape(j), i
        assert _rel(t.numpy(), j) < 1e-10, i


def test_kkt_matrix_with_inequalities_matches_jax():
    """The slack blocks (Sig, -I) and the triu mirror, on QP instances
    (D = 6, N = 16), per instance of a batch."""
    Dq, L = 6, 4
    arr = sample_qp_arrays(3, 2, Dq, L, np.float64)
    rng = np.random.default_rng(2)
    N = 2 * Dq + L
    states = [_state(rng, Dq, 0, N) for _ in range(2)]
    tp = make_qp_problem(Dq, L)
    data = qpdata_from_numpy(arr, device="cpu")
    X, S, LDA = (torch.as_tensor(np.stack([st[i] for st in states]))
                 for i in range(3))
    MU = torch.full((2,), 0.1, dtype=torch.float64)
    H = TK.kkt_matrix(tp, X, S, LDA, MU, data)
    blocks = TK.kkt_blocks(tp, X, S, LDA, MU, data)
    for b in range(2):
        jd = JR.QPData(*(jnp.asarray(arr[k][b]) for k in JR.QPData._fields))
        jp = JR.make_qp_problem(jd, Dq, L)
        args = [jnp.asarray(a) for a in states[b][:3]] + [jnp.asarray(0.1)]
        assert _rel(H[b].numpy(), JK.kkt_matrix(jp, *args)) < 1e-12
        for t, j in zip(blocks, JK.kkt_blocks(jp, *args)):
            assert _rel(t[b].numpy(), j) < 1e-12


@pytest.mark.parametrize("solver", ["condensed", "ldlt"])
def test_dense_nlp_solve_matches_jax(dense, solver):
    """K = 216 > 128, float64: the same signal and iteration count as the
    JAX solver, x within 1e-8."""
    _, jdata, tdata = dense
    jcfg = JCfg(float_dtype="float64", verbosity=0, linear_solver=solver)
    x0 = np.full(D, 1e-3)
    jr = JR.make_dense_nlp_solver(jcfg, D, M)(jnp.asarray(x0), jdata)
    tr = solve(make_dense_nlp_problem(D, M), torch.as_tensor(x0),
               config_from_dict(dataclasses.asdict(jcfg)), params=tdata)
    assert int(jr.signal) in (1, 2)
    assert int(tr.signal) == int(jr.signal)
    assert int(tr.iter_count) == int(jr.iter_count)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(float(tr.fval), float(jr.fval), rtol=1e-10)


def test_ldlt_solver_fleet_matches_jax():
    """The 'ldlt' direction on small full KKT systems (K = 8 + 2*20 = 48,
    the batched small path) with inequalities, per instance of a batch."""
    B, Dq, L = 4, 8, 4
    arr = sample_qp_arrays(5, B, Dq, L, np.float64)
    jcfg = JCfg(float_dtype="float64", verbosity=0, linear_solver="ldlt")
    jdata = JR.QPData(*(jnp.asarray(arr[k]) for k in JR.QPData._fields))
    x0 = np.zeros((B, Dq))
    jr = JR.make_qp_batch_solver(jcfg, Dq, L)(jnp.asarray(x0), jdata)
    tr = solve_batch(make_qp_problem(Dq, L), torch.as_tensor(x0),
                     config_from_dict(dataclasses.asdict(jcfg)),
                     params=qpdata_from_numpy(arr, device="cpu"))
    np.testing.assert_array_equal(tr.signal.numpy(), np.asarray(jr.signal))
    np.testing.assert_array_equal(tr.iter_count.numpy(),
                                  np.asarray(jr.iter_count))
    assert np.all(np.isin(np.asarray(jr.signal), (1, 2)))
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=0,
                               atol=1e-8)


def test_jax_dense_sampler_shapes_carry_across():
    """The JAX package's own sampler output converts too (shapes, dtype)."""
    jd = JR.sample_dense_nlp(jax.random.key(0), 12, 3, hidden=5,
                             dtype=jnp.float64)
    td = dense_from_numpy(jd, device="cpu")
    assert tuple(td.W.shape) == (5, 12) and tuple(td.alpha.shape) == ()
    np.testing.assert_array_equal(td.beq.numpy(), np.asarray(jd.beq))
