"""The port's factorizations of batches of blocks (pyipm_tpu_torch/ops/
linalg.py: ``ldlt_factor_unrolled``, ``ldlt_solve_unrolled_blocks``,
``ldlt_factor_batched``, ``batched_reg_factor``; ops/large_ldlt.py's
``panel_ldlt`` on a batch of panels) against the JAX package's on the same
numpy-seeded float64 blocks.

On the CPU the JAX package factors the n <= 128 branch by its unrolled
form (``vmap(ldlt_factor_small)`` without lane kernels) where the port runs
kernel 1's plain version, so the two are held within 1e-10 relative on
well-conditioned blocks, not bitwise."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pyipm_tpu.config import IPMConfig as JCfg  # noqa: E402
from pyipm_tpu.ops import linalg as JL  # noqa: E402
from pyipm_tpu_torch.ops import large_ldlt as ll  # noqa: E402
from pyipm_tpu_torch.ops import linalg as TL  # noqa: E402

RTOL = 1e-10


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _spd(rng, B, n, lo=1.0, hi=3.0, neg=0):
    Q = np.linalg.qr(rng.standard_normal((B, n, n)))[0]
    w = np.broadcast_to(np.linspace(lo, hi, n), (B, n)).copy()
    w[:, :neg] *= -1
    return np.einsum("bij,bj,bkj->bik", Q, w, Q)


def _blocks(rng, B, d, neq):
    """B condensed blocks [[W, Je^T], [Je, 0]] (x block first): block 0
    has the right inertia, block 1 a W with two negative eigenvalues
    (escalation), the last, with neq > 0, a zero row of Je (an
    ill-conditioned eq block: the eq regularization)."""
    n = d + neq
    H = np.zeros((B, n, n))
    for b in range(B):
        H[b, :d, :d] = _spd(rng, 1, d, neg=2 if b == 1 else 0)[0]
        if neq:
            Je = rng.standard_normal((neq, d))
            if b == B - 1:
                Je[0] = 0.0
            H[b, d:, :d] = Je
            H[b, :d, d:] = Je.T
    return (H + np.swapaxes(H, 1, 2)) / 2


@pytest.mark.parametrize("panel", [16, 32])
@pytest.mark.parametrize("n", [40, 70, 100])
def test_unrolled_factor_and_solve_match_jax(rng, n, panel):
    A = _spd(rng, 3, n, neg=2)
    Lj, dj, ij = JL.ldlt_factor_unrolled(jnp.asarray(A), panel=panel,
                                         want_panel_inv=True)
    Lt, dt, it = TL.ldlt_factor_unrolled(_t(A), panel=panel,
                                         want_panel_inv=True)
    assert _rel(Lt, Lj) < RTOL and _rel(dt, dj) < RTOL
    assert _rel(it, ij) < RTOL
    assert np.array_equal(np.sign(dt.numpy()), np.sign(np.asarray(dj)))
    Bc = rng.standard_normal((3, n, 4))
    xj = JL.ldlt_solve_unrolled_blocks(Lj, dj, ij, jnp.asarray(Bc), panel)
    xt = TL.ldlt_solve_unrolled_blocks(Lt, dt, it, _t(Bc), panel)
    assert _rel(xt, xj) < RTOL
    np.testing.assert_allclose(A @ xt.numpy(), Bc, atol=1e-9)


def test_batched_blocked_factor_matches_jax(rng):
    """The n > 512 factor: panel kernel on the batch of diagonal panels,
    batched triangular solves and trailing products, against the JAX
    package's vmap(ldlt_factor)."""
    A = _spd(rng, 2, 300, neg=3)
    Lj, dj = JL.jax.vmap(lambda a: JL.ldlt_factor(a, block=128))(
        jnp.asarray(A))
    Lt, dt = TL.ldlt_factor_batched(_t(A), block=128)
    assert _rel(Lt, Lj) < RTOL and _rel(dt, dj) < RTOL
    assert np.array_equal(np.sign(dt.numpy()), np.sign(np.asarray(dj)))


def test_panel_ref_on_a_batch_is_the_single_form(rng):
    A = _t(_spd(rng, 5, 24, neg=4))
    A[2, 3, 3] = 0.0               # a zero pivot in one panel
    Lb, db = ll.panel_ldlt(A)
    for b in range(5):
        L1, d1 = ll.panel_ldlt_ref(A[b])
        assert torch.equal(Lb[b], L1) and torch.equal(db[b], d1)


@pytest.mark.parametrize("d,neq", [(14, 2), (30, 6), (196, 4), (570, 6)])
def test_batched_reg_factor_matches_jax(rng, d, neq):
    """n = 16, 36 (kernel 1's branch), 200 (unrolled, panel 32) and 576
    (the batched blocked factor): delta_new, retries, the applied shifts
    and the solves of the three-block batch equal to the JAX function's;
    one block escalates, one needs the eq regularization."""
    cfg = JCfg(float_dtype="float64")
    H = _blocks(rng, 3, d, neq)
    delta = np.array([0.0, 1e-6, 1e-3])
    mu = 0.1
    kw = dict(neq=neq, eps=cfg.eps, reg_coef=cfg.reg_coef, eta=cfg.eta,
              beta=cfg.beta, delta0=cfg.delta0, max_retries=40)
    Bc = rng.standard_normal((3, d + neq, 3))

    @JL.jax.jit                    # one compile: the unrolled forms are long
    def jax_side(H_, delta_, mu_, Bc_):
        solve, dn, r, applied = JL.batched_reg_factor(H_, delta_, mu_, **kw)
        return solve(Bc_), dn, r, applied

    xj, dnj, rj, (daj, eqj) = jax_side(jnp.asarray(H), jnp.asarray(delta),
                                       jnp.asarray(mu), jnp.asarray(Bc))
    st, dnt, rt, (dat, eqt) = TL.batched_reg_factor(
        _t(H), _t(delta), torch.tensor(mu, dtype=torch.float64), **kw)
    assert rt == int(rj) > 0
    np.testing.assert_array_equal(dnt.numpy(), np.asarray(dnj))
    np.testing.assert_array_equal(dat.numpy(), np.asarray(daj))
    np.testing.assert_array_equal(eqt.numpy(), np.asarray(eqj))
    assert eqt[-1] > 0 and dat[1] > 0 and dat[0] == 0
    xt = st(_t(Bc)).numpy()
    for b in range(3):             # per block: the eq-regularized one is huge
        assert _rel(xt[b], xj[b]) < RTOL


def test_batched_reg_factor_keeps_good_blocks(rng):
    """Every block good: the retry phase is skipped (no escalation test
    at all), delta carried, nothing applied."""
    from pyipm_tpu_torch import _sync
    cfg = JCfg(float_dtype="float64")
    H = _spd(rng, 4, 10)
    delta = _t([0.0, 1e-4, 0.0, 2.0])
    _sync.COUNTS["host_syncs"] = 0
    solve, dn, r, (da, eq) = TL.batched_reg_factor(
        _t(H), delta, torch.tensor(0.1, dtype=torch.float64), neq=0,
        eps=cfg.eps, reg_coef=cfg.reg_coef, eta=cfg.eta, beta=cfg.beta,
        delta0=cfg.delta0)
    assert _sync.COUNTS["host_syncs"] == 1 and r == 0
    assert torch.equal(dn, delta) and not da.any() and not eq.any()
    b = rng.standard_normal((4, 10, 1))
    np.testing.assert_allclose(H @ solve(_t(b)).numpy(), b, atol=1e-10)
