"""The port's compact L-BFGS (pyipm_tpu_torch/core/lbfgs.py) against the
JAX package's (pyipm_tpu/core/lbfgs.py) on the CPU, float64.

The memory update through its accept, reject, shift and reset branches
(exactly equal counts, values to 1e-14), the Woodbury direction on the
same memory and iterate for every constraint structure (to 1e-10
relative), the eq-block rcond test and its bump where Je is rank
deficient, whole L-BFGS solves of a dense NLP, and the regime's promise:
no (D+M+N)^2 matrix is formed."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from pyipm_tpu import IPMConfig as JCfg  # noqa: E402
from pyipm_tpu import make_problem as j_make_problem  # noqa: E402
from pyipm_tpu.core import kkt as JK  # noqa: E402
from pyipm_tpu.core import lbfgs as JL  # noqa: E402
from pyipm_tpu.core.solver import make_solver as j_make_solver  # noqa: E402
from pyipm_tpu.models import REFERENCE_PROBLEMS as J_REF  # noqa: E402
from pyipm_tpu.models import random_nlp as JR  # noqa: E402
from pyipm_tpu.ops.linalg import ldlt_factor as j_ldlt_factor  # noqa: E402
from pyipm_tpu_torch import IPMConfig, make_problem, solve  # noqa: E402
from pyipm_tpu_torch.core import lbfgs as TL  # noqa: E402
from pyipm_tpu_torch.interop import (  # noqa: E402
    dense_from_numpy, lbfgs_state_from_numpy,
)
from pyipm_tpu_torch.models import REFERENCE_PROBLEMS as T_REF  # noqa: E402
from pyipm_tpu_torch.models.random_nlp import (  # noqa: E402
    make_dense_nlp_problem, sample_dense_arrays,
)

EPS = float(np.finfo(np.float64).eps)


def _T(a):
    return torch.as_tensor(np.array(a, np.float64))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _pair(rng, D, good):
    """A (dx, dg) pair that passes the curvature test, or one that fails
    it (dg . dx < 0)."""
    dx = rng.standard_normal(D)
    dg = (1.0 + rng.random()) * dx + 0.1 * rng.standard_normal(D)
    return dx, (dg if good else -dg)


@pytest.mark.parametrize("constrained", [True, False])
def test_lbfgs_update_matches_jax(constrained):
    """Four instances through ten updates (mem 3, fail_max 2): always
    accepted (grow, then shift), alternating, accepted then rejected until
    the reset, always rejected (count 0: never reset)."""
    D, mem, fail_max, zeta0 = 5, 3, 2, 1.0
    patterns = ["gggggggggg", "gbgbgbgbgb", "ggbbbbgbbb", "bbbbbbbbbb"]
    rng = np.random.default_rng(0)
    pairs = [[_pair(rng, D, c == "g") for c in pat] for pat in patterns]
    jst = [JL.lbfgs_init(D, mem, zeta0, jnp.float64) for _ in patterns]
    tst = TL.lbfgs_init(len(patterns), D, mem, zeta0, torch.float64, "cpu")
    kw = dict(constrained=constrained, eps=EPS, zeta0=zeta0,
              fail_max=fail_max)
    resets = 0
    for k in range(len(patterns[0])):
        jst = [JL.lbfgs_update(st, jnp.asarray(pairs[i][k][0]),
                               jnp.asarray(pairs[i][k][1]), **kw)
               for i, st in enumerate(jst)]
        before = tst.count.clone()
        tst = TL.lbfgs_update(tst, _T([p[k][0] for p in pairs]),
                              _T([p[k][1] for p in pairs]), **kw)
        resets += int(((before > 0) & (tst.count == 0)).sum())
        for i, st in enumerate(jst):
            assert int(tst.count[i]) == int(st.count)
            assert int(tst.fail[i]) == int(st.fail)
            for name in ("zeta", "S", "Y"):
                np.testing.assert_allclose(
                    getattr(tst, name)[i].numpy(),
                    np.asarray(getattr(st, name)), rtol=1e-14, atol=1e-14,
                    err_msg=f"{name}, instance {i}, step {k}")
    assert resets >= 1 and int(tst.count[0]) == mem


def _memory(D, lbfgs, n_updates, constrained, seed):
    """A JAX L-BFGS memory after ``n_updates`` accepted pairs."""
    rng = np.random.default_rng(seed)
    st = JL.lbfgs_init(D, lbfgs + 1, 1.0, jnp.float64)
    for _ in range(n_updates):
        dx, dg = _pair(rng, D, True)
        st = JL.lbfgs_update(st, jnp.asarray(dx), jnp.asarray(dg),
                             constrained=constrained, eps=EPS, zeta0=1.0,
                             fail_max=lbfgs)
    return st


def _dense(D, M, hidden=16):
    arr = sample_dense_arrays(1, D, M, hidden, np.float64)
    jdata = JR.DenseNLPData(*(jnp.asarray(arr[k])
                              for k in JR.DenseNLPData._fields))
    tdata = dense_from_numpy(jdata, device="cpu")
    return (JR.make_dense_nlp_problem(jdata, D, M),
            make_dense_nlp_problem(D, M),
            type(tdata)(*(t[None] for t in tdata)))


def _direction(jprob, tprob, params, n_updates, seed=3, with_block=False):
    """Both packages' direction on the same memory and random iterate."""
    D, M, N = tprob.nvar, tprob.neq, tprob.nineq
    rng = np.random.default_rng(seed)
    x = 0.3 * np.abs(rng.standard_normal(D)) + 0.05
    s = np.abs(rng.standard_normal(N)) + 0.2
    lda = rng.standard_normal(M + N)
    lda[M:] = np.abs(lda[M:]) + 0.1
    mu = 0.05
    jst = _memory(D, 4, n_updates, tprob.ncon > 0, seed)
    jcfg = JCfg(verbosity=0, lbfgs=4)
    g = -JK.grad(jprob, jnp.asarray(x), jnp.asarray(s), jnp.asarray(lda),
                 jnp.asarray(mu))
    want = jax.jit(lambda *a: JL.lbfgs_direction(jprob, jcfg, *a))(
        jst, jnp.asarray(x), jnp.asarray(s), jnp.asarray(lda), g,
        jnp.asarray(mu))
    tst = lbfgs_state_from_numpy(jst, device="cpu")
    got = TL.lbfgs_direction(
        tprob, IPMConfig(verbosity=0, lbfgs=4), tst, _T(x)[None],
        _T(s)[None], _T(lda)[None], _T(g)[None], _T([mu]), params)
    if not with_block:
        return got[0].numpy(), np.asarray(want)
    Je = np.asarray(jprob.jac_ce(jnp.asarray(x)))
    G = Je.T @ Je / float(jst.zeta)
    bump, _ = TL.eq_block_bump(_T(G)[None], _T([mu]), IPMConfig(lbfgs=4))
    return got[0].numpy(), np.asarray(want), G + float(bump[0]) * np.eye(
        len(G))


@pytest.mark.parametrize("case,n_updates", [
    ("p2", 2), ("p2", 7), ("p8", 3), ("p5", 5), ("p6", 7), ("p10", 1),
    ("dense", 4),
])
def test_lbfgs_direction_matches_jax(case, n_updates):
    """Unconstrained (2), equalities only (8), inequalities only (5), both
    (6, 10) and a dense NLP (D = 40, M = 4), with a partly filled and a
    full (shifted) memory."""
    if case == "dense":
        jprob, tprob, params = _dense(40, 4)
    else:
        num = int(case[1:])
        jprob, tprob, params = J_REF[num].make(), T_REF[num].make(), ()
    got, want = _direction(jprob, tprob, params, n_updates)
    assert _rel(got, want) <= 1e-10


def _parallel_eq(scale):
    """Two equality constraints whose Jacobian columns are parallel up to
    ``scale`` (rank deficient at 0)."""
    def f(x):
        return (x[0] - 1.0) ** 2 + (x[1] + 0.5) ** 2 + x[2] ** 2

    def ce(x):
        s = x[0] + x[1] + x[2] - 1.0
        return jnp.stack([s, 2.0 * s + scale * x[0]])

    def tf(x, p):
        return (x[0] - 1.0) ** 2 + (x[1] + 0.5) ** 2 + x[2] ** 2

    def tce(x, p):
        s = x[0] + x[1] + x[2] - 1.0
        return torch.stack([s, 2.0 * s + scale * x[0]])

    return j_make_problem(f, 3, ce=ce), make_problem(tf, 3, ce=tce)


@pytest.mark.parametrize("scale,bumps", [(0.0, True), (0.5, False)])
def test_eq_block_rcond_and_bump_match_jax(scale, bumps):
    """The rcond of the M x M block Je' diag(1/Adiag) Je from the pivots of
    its LDL^T, and the bump it decides, as the JAX package computes them;
    on a rank-deficient Je the bump fires and the directions still
    agree: the primal part to 1e-10, the multipliers, which the bumped
    block (condition ~1/bump ~ 1e13) determines, within 10 n eps cond of
    it, the forward-error bound of an LU solve."""
    jprob, tprob = _parallel_eq(scale)
    x = np.array([0.3, 0.2, 0.1])
    zeta = 1.7
    Je = np.asarray(jprob.jac_ce(jnp.asarray(x)))
    G = Je.T @ Je / zeta
    _, jd = j_ldlt_factor(jnp.asarray(G))
    ad = np.abs(np.asarray(jd))
    j_rcond = ad.min() / max(ad.max(), np.finfo(np.float64).tiny)
    cfg = IPMConfig(verbosity=0, lbfgs=4)
    mu = _T([0.1])
    bump, rcond = TL.eq_block_bump(_T(G)[None], mu, cfg)
    assert (float(bump[0]) > 0) == bumps == (j_rcond <= EPS)
    if bumps:
        assert float(rcond[0]) <= EPS
        np.testing.assert_allclose(
            float(bump[0]), cfg.reg_coef * cfg.eta * 0.1 ** cfg.beta,
            rtol=1e-14)
    else:
        np.testing.assert_allclose(float(rcond[0]), j_rcond, rtol=1e-12)
    got, want, block = _direction(jprob, tprob, (), 3, with_block=True)
    assert _rel(got[:3], want[:3]) <= 1e-10
    assert _rel(got[3:], want[3:]) <= max(
        1e-10, 10 * len(block) * EPS * np.linalg.cond(block))


def _dense_solves(D, M, hidden):
    arr = sample_dense_arrays(0, D, M, hidden, np.float64)
    jdata = JR.DenseNLPData(*(jnp.asarray(arr[k])
                              for k in JR.DenseNLPData._fields))
    kw = dict(float_dtype="float64", verbosity=0, lbfgs=8, niter=10,
              miter=60)
    jr = j_make_solver(JR.make_dense_nlp_problem(jdata, D, M), JCfg(**kw))(
        jnp.zeros((D,)))
    tr = solve(make_dense_nlp_problem(D, M),
               torch.zeros(D, dtype=torch.float64), IPMConfig(**kw),
               params=dense_from_numpy(jdata, device="cpu"))
    assert int(tr.signal) == int(jr.signal) == 1
    assert int(tr.iter_count) == int(jr.iter_count)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=0,
                               atol=1e-8)
    assert float(tr.kkt.max()) <= 1e-4


def test_lbfgs_dense_solve_matches_jax():
    """L-BFGS(8) on a dense NLP at D = 200, M = 8 (the D = 4096 regime of
    test_lbfgs_large.py:26 at a Tier-1 size)."""
    _dense_solves(200, 8, 32)


@pytest.mark.slow
def test_lbfgs_dense_solve_matches_jax_d4096():
    """The configuration of test_lbfgs_large.py:26-37 (D = 4096, M = 8,
    L-BFGS(8), float64) on a numpy-drawn instance."""
    _dense_solves(4096, 8, 256)


class _Shapes(TorchDispatchMode):
    """Records the shape of every tensor an operator returns."""

    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.shapes.add(tuple(t.shape))
        return out


def test_lbfgs_never_forms_the_kkt_matrix():
    """An L-BFGS solve at D = 256, M = 4 returns no tensor with two trailing
    dimensions of the composite size D+M or more (test_lbfgs_large.py:66
    asserts the same on the JAX package's jaxpr at D = 512; the property
    does not depend on D)."""
    D, M = 256, 4
    arr = sample_dense_arrays(2, D, M, 16, np.float64)
    data = dense_from_numpy(arr, device="cpu")
    cfg = IPMConfig(float_dtype="float64", verbosity=0, lbfgs=8)
    with _Shapes() as rec:
        r = solve(make_dense_nlp_problem(D, M),
                  torch.zeros(D, dtype=torch.float64), cfg, params=data)
    assert int(r.signal) in (1, 2)
    assert any(len(s) >= 2 and s[-1] == D for s in rec.shapes)
    big = [s for s in rec.shapes
           if len(s) >= 2 and min(s[-2:]) >= D + M]
    assert not big, big


def test_lbfgs_state_from_numpy():
    """One instance (the JAX package's state) and a batch (a dict)."""
    st = _memory(6, 3, 2, True, 0)
    t = lbfgs_state_from_numpy(st, device="cpu")
    assert t.S.shape == (1, 6, 4) and t.count.dtype == torch.int32
    assert int(t.count[0]) == 2
    np.testing.assert_array_equal(t.Y[0].numpy(), np.asarray(st.Y))
    batch = {k: np.stack([np.asarray(getattr(st, k))] * 3)
             for k in TL.LBFGSState._fields}
    tb = lbfgs_state_from_numpy(batch, device="cpu", dtype=torch.float32)
    assert tb.S.shape == (3, 6, 4) and tb.zeta.dtype == torch.float32
    assert tb.count.shape == (3,)
