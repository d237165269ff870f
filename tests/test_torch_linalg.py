"""The port's inertia-corrected small KKT solve and min-norm least squares
(pyipm_tpu_torch/ops/linalg.py) against the JAX package's, on identical
numpy-seeded systems.

Each port call is a BATCH of systems that take different paths (kept,
escalated, gated), so the masked per-instance loops are exercised; each
instance must give the JAX result for that system alone: the same
``retries`` and ``delta_new`` and the same ``dz`` within the dtype's
roundoff.

The JAX package has two small-system paths: on the TPU, batched solves go
through the Pallas lane kernels (right-looking factor, substitution solve
— what the port's kernels compute); on the CPU, through the blocked
unrolled factor and a log-depth-inverse solve, whose residual is
~|L||L^-1| larger.  On the adversarial near-singular systems the two JAX
paths differ: the inverse solve trips the residual gate, substitution does
not.  So the port is held to the JAX kernel path there (Pallas kernels in
interpret mode), and its gate loop to the JAX CPU path with the port's
solve swapped for the same inverse form."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from pyipm_tpu.config import IPMConfig as JCfg  # noqa: E402
from pyipm_tpu.ops import pallas_ldlt as pk  # noqa: E402
from pyipm_tpu.ops.linalg import lstsq_minnorm as j_lstsq  # noqa: E402
from pyipm_tpu.ops.linalg import reg_solve_kkt as j_reg  # noqa: E402
from pyipm_tpu_torch.ops import linalg as TL  # noqa: E402
from pyipm_tpu_torch.ops.linalg import lstsq_minnorm as t_lstsq  # noqa: E402
from pyipm_tpu_torch.ops.linalg import reg_solve_kkt as t_reg  # noqa: E402

RTOL = {"float64": 1e-8, "float32": 2e-3}


def _saddle(rng, D, M, neg_w):
    """[[W, Je], [Je', 0]] with W having ``neg_w`` negative eigenvalues."""
    Q = np.linalg.qr(rng.standard_normal((D, D)))[0]
    w = np.linspace(1.0, 3.0, D)
    w[:neg_w] *= -1
    H = np.zeros((D + M, D + M))
    H[:D, :D] = (Q * w) @ Q.T
    Je = rng.standard_normal((D, M))
    H[:D, D:] = Je
    H[D:, :D] = Je.T
    return (H + H.T) / 2


def _adversarial(piv, n=64, nneg=8, seed=0):
    """test_components.py:298-345: a tiny leading pivot the inertia test
    cannot see; the residual gate must escalate."""
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    w = np.linspace(1, 2, n)
    w[:nneg] *= -1
    A = (Q * w) @ Q.T
    A[0, 0] = piv
    A = (A + A.T) / 2
    return A, rng.standard_normal(n), int(np.sum(np.linalg.eigvalsh(A) < 0))


def _stable(n=48, nneg=6, seed=1):
    """test_components.py:347-374: a well-conditioned system the gate must
    leave alone."""
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    w = np.linspace(1, 3, n)
    w[:nneg] *= -1
    A = (Q * w) @ Q.T
    return (A + A.T) / 2, rng.standard_normal(n), nneg


def _run_both(Hs, gs, deltas, mus, nvar, neq, dtype, want_solver,
              max_retries=40):
    cfg = JCfg(float_dtype=dtype)
    kw = dict(nvar=nvar, neq=neq, nineq=0, eps=cfg.eps, reg_coef=cfg.reg_coef,
              eta=cfg.eta, beta=cfg.beta, delta0=cfg.delta0,
              max_retries=max_retries)
    jdt = jnp.dtype(dtype)
    rhs2 = jnp.asarray(np.cos(np.arange(Hs.shape[-1]) + 1.0), jdt)

    @jax.jit
    def jax_one(H_, g_, dl_, mu_):
        out = j_reg(H_, g_, dl_, mu_, method="ldlt", want_solver=want_solver,
                    **kw)
        if want_solver:
            return out[:3] + (out[3](rhs2),) + tuple(out[4])
        return out

    want = [[np.asarray(o) for o in jax_one(*(jnp.asarray(a, jdt)
                                              for a in args))]
            for args in zip(Hs, gs, deltas, mus)]
    tdt = getattr(torch, dtype)
    T = lambda a: torch.as_tensor(np.asarray(a), dtype=tdt)  # noqa: E731
    got = t_reg(T(Hs), T(gs), T(deltas), T(mus), want_solver=want_solver,
                **kw)
    if want_solver:
        dz, dn, rt, apply_factors, (d_app, e_app) = got
        rhs2_b = T(np.tile(np.asarray(rhs2), (len(Hs), 1)))
        got = (dz, dn, rt, apply_factors(rhs2_b),
               d_app, e_app)
    got = [g.numpy() for g in got]
    return got, want


def _check(got, want, dtype, rtol=None, apply_rtol=None, applied=True):
    rtol = RTOL[dtype] if rtol is None else rtol
    apply_rtol = rtol if apply_rtol is None else apply_rtol
    for i, w in enumerate(want):
        dz, dn, rt = got[0][i], got[1][i], got[2][i]
        assert int(rt) == int(w[2]), (i, int(rt), int(w[2]))
        np.testing.assert_allclose(dn, w[1], rtol=1e-12 if dtype == "float64"
                                   else 1e-6, err_msg=f"delta_new {i}")
        scale = np.abs(w[0]).max()
        if rtol:
            np.testing.assert_allclose(dz, w[0], rtol=rtol, atol=rtol * scale,
                                       err_msg=f"dz {i}")
        if len(w) > 3:
            if apply_rtol:
                np.testing.assert_allclose(got[3][i], w[3], rtol=apply_rtol,
                                           atol=apply_rtol * np.abs(w[3]).max())
            if applied:
                np.testing.assert_allclose(got[4][i], w[4], rtol=1e-12)
                np.testing.assert_allclose(got[5][i], w[5], rtol=1e-12)


@pytest.mark.parametrize("want_solver", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_healthy_and_escalating_systems(dtype, want_solver):
    """A batch of saddle systems: correct inertia (kept), a wrong-inertia
    primal block (delta escalation), and a warm-started delta."""
    rng = np.random.default_rng(0)
    D, M = 9, 3
    Hs = np.stack([_saddle(rng, D, M, 0), _saddle(rng, D, M, 3),
                   _saddle(rng, D, M, 0), _saddle(rng, D, M, 5)])
    gs = rng.standard_normal((4, D + M))
    deltas = np.array([0.0, 0.0, 0.0, 2e-2])
    mus = np.array([0.1, 0.2, 0.05, 0.3])
    got, want = _run_both(Hs, gs, deltas, mus, D, M, dtype, want_solver)
    assert int(want[0][2]) == 0 and float(want[0][1]) == 0.0
    assert float(want[1][1]) > 0.0          # escalation happened
    _check(got, want, dtype)


ADVERSARIAL = [("float64", 1e-8), ("float64", 1e-12), ("float32", 1e-5)]


def _adversarial_batch(dtype, piv):
    A, g, nneg = _adversarial(piv)
    S, gs_, _ = _stable(n=64, nneg=nneg, seed=4)
    return (np.stack([A, S]).astype(dtype), np.stack([g, gs_]).astype(dtype),
            nneg, A, g)


def _bkw_ok(A, g, dz, delta_new, nvar, dtype):
    """test_components.py:333-344: backward error of the direction against
    the system actually solved (primal block shifted by delta_new)."""
    ex = np.zeros(A.shape[0])
    ex[:nvar] = 1
    Ash = A + float(delta_new) * np.diag(ex)
    dz64 = np.asarray(dz, np.float64)
    bkw = (np.linalg.norm(Ash @ dz64 - g)
           / (np.linalg.norm(Ash) * np.linalg.norm(dz64) + np.linalg.norm(g)))
    assert bkw <= (1e-7 if dtype == "float64" else 1e-4), bkw


@pytest.mark.parametrize("want_solver", [False, True])
@pytest.mark.parametrize("dtype,piv", ADVERSARIAL)
def test_near_singular_matches_jax_kernel_path(dtype, piv, want_solver,
                                               monkeypatch):
    """The adversarial systems of test_components.py:295-344, batched with
    a second system of the same inertia, against JAX's reg_solve_kkt as it
    runs on the TPU: vmapped, through the Pallas lane kernels (interpret
    mode)."""
    Hs, gs, nneg, A, g = _adversarial_batch(dtype, piv)
    cfg = JCfg(float_dtype=dtype)
    kw = dict(nvar=64 - nneg, neq=nneg, nineq=0, eps=cfg.eps,
              reg_coef=cfg.reg_coef, eta=cfg.eta, beta=cfg.beta,
              delta0=cfg.delta0, max_retries=20)
    monkeypatch.setattr(pk, "_lane_dispatch", lambda n, b, dt: True)

    def jax_one(H, g_):
        z = jnp.zeros((), H.dtype)
        out = j_reg(H, g_, z, z + 0.1, method="ldlt",
                    want_solver=want_solver, **kw)
        return out[:3]

    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(jax.vmap(jax_one))(jnp.asarray(Hs), jnp.asarray(gs))
    want = [[np.asarray(w[i]) for w in want] for i in range(2)]
    tdt = getattr(torch, dtype)
    got = TL.reg_solve_kkt(
        torch.tensor(Hs), torch.tensor(gs), torch.zeros(2, dtype=tdt),
        torch.full((2,), 0.1, dtype=tdt), want_solver=want_solver, **kw)
    got = [t.numpy() for t in got[:3]]
    _check(got, want, dtype)
    _bkw_ok(A, g, got[0][0], got[1][0], 64 - nneg, dtype)


def _jax_cpu_small(fn):
    """A port-side (torch in, torch out) call of the JAX package's CPU
    small-system factor or solve (vmapped: blocked unrolled factor,
    log-depth-inverse solve)."""
    mapped = jax.jit(jax.vmap(fn))

    def call(*args):
        out = mapped(*(jnp.asarray(a.numpy()) for a in args))
        if isinstance(out, tuple):
            return tuple(torch.tensor(np.asarray(o)) for o in out)
        return torch.tensor(np.asarray(out))
    return call


@pytest.mark.parametrize("want_solver", [False, True])
@pytest.mark.parametrize("dtype,piv", ADVERSARIAL)
def test_residual_gate_matches_jax_cpu_path(dtype, piv, want_solver,
                                            monkeypatch):
    """With the port's small factor and solve swapped for the JAX CPU
    path's, the adversarial systems trip the residual gate in both
    packages, and the port's gate loop reproduces JAX's escalation: equal
    retries and delta_new, dz to roundoff."""
    Hs, gs, nneg, A, g = _adversarial_batch(dtype, piv)
    monkeypatch.setattr(TL, "ldlt_factor_small",
                        _jax_cpu_small(pk.ldlt_factor_small))
    jax_solve = _jax_cpu_small(pk.ldlt_solve_small)
    # the port's solve takes the Ruiz scale; the JAX one gets it outside
    monkeypatch.setattr(
        TL, "ldlt_solve_small",
        lambda L, d, b, scale: scale * jax_solve(L, d, scale * b))
    got, want = _run_both(Hs, gs, np.zeros(2), np.full(2, 0.1), 64 - nneg,
                          nneg, dtype, want_solver, max_retries=20)
    assert int(want[0][2]) > 0, "residual gate did not trigger in JAX"
    # the gated directions solve systems still conditioned ~1e6 and up
    # through a factorization with O(1e-2) backward error before
    # refinement, so roundoff-level differences upstream of the gate move
    # dz well beyond eps: compare dz to 1e-6 in float64, and in float32
    # only through the backward-error contract both directions meet; a
    # further solve through those unrefined factors is not compared.  In
    # float32 the first factorization's scaled rcond sits at eps here, so
    # whether the eq-block shift applies flips with the Ruiz sums' order
    # (it does not change retries or delta_new): compared in float64 only
    _check(got, want, dtype, rtol=1e-6 if dtype == "float64" else 0.0,
           apply_rtol=0.0, applied=dtype == "float64")
    _bkw_ok(A, g, got[0][0], got[1][0], 64 - nneg, dtype)
    _bkw_ok(A, g, want[0][0], want[0][1], 64 - nneg, dtype)


@pytest.mark.parametrize("want_solver", [False, True])
def test_gate_quiet_on_stable_system(want_solver):
    A, g, nneg = _stable()
    got, want = _run_both(A[None], g[None], np.zeros(1), np.full(1, 0.1),
                          48 - nneg, nneg, "float64", want_solver,
                          max_retries=20)
    assert int(got[2][0]) == 0 and float(got[1][0]) == 0.0
    _check(got, want, "float64")
    r = np.linalg.norm(A @ got[0][0] - g) / np.linalg.norm(g)
    assert r <= 1e-10, r


def test_large_systems_raise():
    """K > 128 takes the blocked path, whose panels must fit the panel
    kernel (block <= 128): a larger block raises."""
    H = torch.eye(130, dtype=torch.float64)[None]
    with pytest.raises(ValueError, match="block"):
        t_reg(H, torch.ones(1, 130, dtype=torch.float64),
              torch.zeros(1, dtype=torch.float64),
              torch.ones(1, dtype=torch.float64), nvar=130, neq=0, nineq=0,
              eps=1e-16, reg_coef=1e-8, eta=1e-4, beta=0.4, delta0=1e-8,
              block=256)


def _lstsq_cases(kind, rng):
    if kind == "under":
        return [rng.standard_normal((m, n)) for m, n in [(3, 8), (6, 20)]]
    if kind == "over":
        return [rng.standard_normal((m, n)) for m, n in [(8, 3), (20, 6)]]
    U, V = rng.standard_normal((6, 3)), rng.standard_normal((3, 10))
    return [U @ V]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kind", ["under", "over", "rank_deficient"])
def test_lstsq_minnorm_matches_jax(kind, dtype):
    rng = np.random.default_rng({"under": 0, "over": 1,
                                 "rank_deficient": 2}[kind])
    for A in _lstsq_cases(kind, rng):
        As = np.stack([A, A * 0.5 + 0.1 * rng.standard_normal(A.shape)])
        bs = rng.standard_normal((2, A.shape[0]))
        As, bs = As.astype(dtype), bs.astype(dtype)
        want = np.stack([np.asarray(j_lstsq(jnp.asarray(a), jnp.asarray(b)))
                         for a, b in zip(As, bs)])
        got = t_lstsq(torch.as_tensor(As), torch.as_tensor(bs)).numpy()
        # rank deficiency amplifies roundoff by ~1/sqrt(eps) through the
        # Tikhonov-regularized normal equations
        rtol = {("float64", False): 1e-10, ("float64", True): 1e-6,
                ("float32", False): 1e-4, ("float32", True): 2e-2}[
            (dtype, kind == "rank_deficient")]
        err = np.linalg.norm(got - want, axis=-1) / np.linalg.norm(want,
                                                                   axis=-1)
        assert np.all(err <= rtol), (kind, dtype, err)
