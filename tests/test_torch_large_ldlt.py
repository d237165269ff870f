"""The port's large-K path (pyipm_tpu_torch/ops/large_ldlt.py and the
K > 128 half of ops/linalg.py) against the JAX package, on identical
numpy-seeded inputs.

The Pallas kernels run as tests/test_pallas_ldlt.py runs them, in
interpret mode.  The JAX package's CPU factorization factors each panel
with ``ldlt_unblocked`` (left-looking), the port with the Pallas panel
kernel's right-looking arithmetic (the port's ``panel_ldlt`` on the CPU is
that kernel's plain version), so the two agree to roundoff: float64
results are compared to 1e-10 relative.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from pyipm_tpu.config import IPMConfig as JCfg  # noqa: E402
from pyipm_tpu.ops import linalg as JL  # noqa: E402
from pyipm_tpu.ops import pallas_ldlt as pk  # noqa: E402
from pyipm_tpu_torch.ops import large_ldlt as ll  # noqa: E402
from pyipm_tpu_torch.ops import linalg as TL  # noqa: E402

SIZES = [216, 1100]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _T(a):
    return torch.as_tensor(np.asarray(a))


def _rand_sym(rng, n, shift):
    A = rng.standard_normal((n, n))
    return (A + A.T) / 2 + np.eye(n) * shift


def _indef(rng, n):
    """Symmetric indefinite, pivots well away from 0 (alternating-sign
    dominant diagonal), so unpivoted factors agree to roundoff."""
    sgn = np.where(np.arange(n) % 3 == 0, -1.0, 1.0)
    return 0.5 * _rand_sym(rng, n, 0.0) + np.diag(sgn * n / 2)


def _exact_zero_pivot_panel(rng, n):
    """A panel whose factorization by the panel kernel's recurrence is
    exact (small integers, pivots in {0, +-1, +-2}) and has zero pivots
    with nonzero columns below them, where the panel kernel still
    subtracts l l^T (safe = 1).  Built by running that recurrence
    backwards: A = sum_j s_j l_j l_j^T - sum_{d_j = 0} e_j e_j^T."""
    Lr = np.tril(rng.integers(-1, 2, (n, n)), -1) + np.eye(n)
    d = rng.choice([1.0, -1.0, 2.0, -2.0], n)
    d[[1, n // 3, n - 5]] = 0.0
    safe = np.where(d != 0, d, 1.0)
    A = (Lr * safe) @ Lr.T
    A[d == 0, d == 0] -= 1.0
    return A, Lr, d


# ----------------------------------------------------------------------
# kernel 3: the panel
@pytest.mark.parametrize("n", [64, 128])
def test_panel_ref_matches_pallas_interpret(rng, n):
    """Tolerances of test_pallas_ldlt.py:69-76.  (XLA's CPU backend fuses
    the kernel's trailing update into an FMA, the port rounds the product
    first, so general panels agree to roundoff, not bitwise.)"""
    A = _rand_sym(rng, n, n / 4).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        Lk, dk = pk.panel_ldlt(jnp.asarray(A))
    L, d = ll.panel_ldlt_ref(torch.as_tensor(A))
    np.testing.assert_allclose(d.numpy(), np.asarray(dk), rtol=5e-3,
                               atol=1e-3)
    np.testing.assert_allclose(L.numpy(), np.asarray(Lk), rtol=5e-3,
                               atol=1e-3)
    rec = L.numpy() @ np.diag(d.numpy()) @ L.numpy().T
    scale = float(np.abs(A).max())
    np.testing.assert_allclose(rec, A, atol=5e-5 * scale * n, rtol=1e-4)
    np.testing.assert_array_equal(d.numpy() < 0, np.asarray(dk) < 0)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [64, 128])
def test_panel_ref_bitwise_on_zero_pivot_panel(n, dtype):
    """Bitwise equal to the Pallas panel kernel (interpret mode) on a
    panel with exact zero pivots; the JAX package's ``ldlt_unblocked``
    subtracts nothing at a zero pivot and so gives other pivots after it
    (a divergence inside the reference, ROADMAP Queue 3)."""
    A, Lr, dr = _exact_zero_pivot_panel(np.random.default_rng(n), n)
    A = A.astype(dtype)
    with pltpu.force_tpu_interpret_mode():
        Lk, dk = pk.panel_ldlt(jnp.asarray(A))
    L, d = ll.panel_ldlt(torch.as_tensor(A))           # CPU: plain version
    np.testing.assert_array_equal(d.numpy(), np.asarray(dk))
    np.testing.assert_array_equal(L.numpy(), np.asarray(Lk))
    np.testing.assert_array_equal(d.numpy(), dr)
    np.testing.assert_array_equal(L.numpy(), Lr)
    _, du = JL.ldlt_unblocked(jnp.asarray(A))
    assert not np.array_equal(np.asarray(du), dr)


def test_panel_wrapper_checks():
    with pytest.raises(ValueError):
        ll.panel_ldlt(torch.eye(129))
    with pytest.raises(ValueError):
        ll.panel_ldlt(torch.ones(4, 5))
    with pytest.raises(ValueError):
        ll.panel_ldlt(torch.eye(8).T[:, :4].T)         # not contiguous
    with pytest.raises(TypeError):
        ll.panel_ldlt(torch.eye(8, dtype=torch.float16))


@pytest.mark.parametrize("B,sms,dtype,per_sm", [
    (1, 132, torch.float32, 1),
    (131, 132, torch.float32, 1),
    (132, 132, torch.float32, 1),
    (133, 132, torch.float32, 2),
    (256, 132, torch.float32, 2),
    (264, 132, torch.float32, 2),
    (265, 132, torch.float32, 2),
    (256, 132, torch.float64, 1),
    (115, 114, torch.float32, 2),
    (114, 114, torch.float32, 1),
])
def test_panels_per_sm_by_batch_and_sm_count(B, sms, dtype, per_sm):
    """The panel kernel's variant: two panels an SM only for float32
    batches of more panels than the card has SMs."""
    assert ll.panels_per_sm(B, sms, dtype) == per_sm


def test_panel_wrapper_on_cpu_is_plain_at_any_batch(rng):
    """A CPU batch takes the plain version whatever its size, launching
    nothing and asking no card for its SM count."""
    A = torch.as_tensor(np.repeat(_rand_sym(rng, 8, 2.0)[None], 133, 0),
                        dtype=torch.float32)
    n0 = dict(ll.LAUNCHES)
    L, d = ll.panel_ldlt(A)
    Lr, dr = ll.panel_ldlt_ref(A)
    assert torch.equal(L, Lr) and torch.equal(d, dr)
    assert ll.LAUNCHES == n0


# ----------------------------------------------------------------------
# kernels 4 and 5: the backward sweeps
def _jax_panel_factors(rng, n, dtype, group=8):
    A = _rand_sym(rng, n, n)
    b = rng.standard_normal(n)
    Lp, dp, invp, yf = JL.ldlt_factor_panels(
        jnp.asarray(A, dtype), block=128, group=group,
        rhs=jnp.asarray(b, dtype))
    z = yf / jnp.where(jnp.abs(dp) > 0, dp, 1.0)
    return Lp, z, invp


def test_bwd_sweep_panels_matches_pallas_interpret_and_xla(rng):
    """n = 1900 pads to 2048: several streamed chunks and superblocks
    (geometries of test_pallas_ldlt.py:189), float32, to the JAX test's
    2e-5."""
    Lp, z, invp = _jax_panel_factors(rng, 1900, jnp.float32)
    got = ll.bwd_sweep_panels(_T(Lp), _T(z), _T(invp)).numpy()
    ref = np.asarray(JL._bwd_sweep_panels_xla(Lp, z, invp))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    for SB, R in ((1024, 512), (1024, 256), (512, 128)):
        with pltpu.force_tpu_interpret_mode():
            x = np.asarray(pk._bwd_sweep_panels_pallas(Lp, z, invp, SB, R))
        np.testing.assert_allclose(got, x, rtol=2e-5, atol=2e-5,
                                   err_msg=f"SB={SB} R={R}")


@pytest.mark.parametrize("n", [300, 1900])
def test_bwd_sweeps_match_xla_f64(rng, n):
    """Both sweeps in float64 against the JAX XLA sweeps, on
    ldlt_factor_blocks and ldlt_factor_panels factors."""
    Lp, z, invp = _jax_panel_factors(rng, n, jnp.float64)
    got = ll.bwd_sweep_panels(_T(Lp), _T(z), _T(invp)).numpy()
    assert _rel(got, JL._bwd_sweep_panels_xla(Lp, z, invp)) < 1e-10
    A = _rand_sym(rng, n, n)
    b = rng.standard_normal(n)
    L, d, invb, yf = JL.ldlt_factor_blocks(
        jnp.asarray(A), block=128, group=4, rhs=jnp.asarray(b),
        pad_to_grid=True)
    z = yf / jnp.where(jnp.abs(d) > 0, d, 1.0)
    got = ll.bwd_sweep_blocks(_T(L), _T(z), _T(invb)).numpy()
    assert _rel(got, JL._bwd_sweep_xla(L, z, invb)) < 1e-10


def _unit_lower_panels(rng, npad, dtype):
    """A random unit-lower Lp (npad, npad), the inverses of its 128-wide
    diagonal panels and a right-hand side, as numpy arrays."""
    Lp = np.tril(rng.standard_normal((npad, npad), dtype=dtype), -1)
    Lp = Lp / dtype(np.sqrt(npad)) + np.eye(npad, dtype=dtype)
    invp = np.stack([np.linalg.inv(Lp[k:k + 128, k:k + 128].astype(np.float64))
                     for k in range(0, npad, 128)]).astype(dtype)
    return Lp, invp, rng.standard_normal(npad).astype(dtype)


@pytest.mark.parametrize("nsteps", [1, 2])
def test_bwd_sweep_ref_matches_xla_panels_f64(rng, nsteps):
    """The plain sweep against the JAX XLA panel sweep and a dense
    triangular solve, in float64, at one and two 128-blocks."""
    Lp, invp, z = _unit_lower_panels(rng, 128 * nsteps, np.float64)
    got = ll.bwd_sweep_ref(_T(Lp), _T(z), _T(invp)).numpy()
    want = JL._bwd_sweep_panels_xla(jnp.asarray(Lp), jnp.asarray(z),
                                    jnp.asarray(invp))
    assert _rel(got, want) < 1e-10
    assert _rel(got, np.linalg.solve(Lp.T, z)) < 1e-10


@pytest.mark.parametrize("npad", [128, 256, 2048, 5120])
def test_panel_sweep_wrapper_checks_and_flags(rng, npad):
    """The one-launch panel sweep's wrapper: one zeroed int32 ready flag
    per 128-block, 128-wide panels only, and on the CPU the plain sweep
    (against a dense triangular solve, float32)."""
    flags = ll.panel_sweep_flags(npad, "cpu")
    assert flags.dtype == torch.int32
    assert tuple(flags.shape) == (npad // 128,) and not bool(flags.any())
    Lp, invp, z = _unit_lower_panels(rng, npad, np.float32)
    Lp, invp, z = _T(Lp), _T(invp), _T(z)
    with pytest.raises(ValueError, match="128-wide"):
        ll.bwd_sweep_panels(Lp, z, torch.eye(64).repeat(npad // 64, 1, 1))
    with pytest.raises(ValueError, match="tile"):
        ll.bwd_sweep_panels(Lp, z, torch.eye(256).repeat(
            max(npad // 256, 1), 1, 1))
    x = ll.bwd_sweep_panels(Lp, z, invp)
    want = torch.linalg.solve_triangular(Lp.T, z[:, None], upper=True,
                                         unitriangular=True)[:, 0]
    assert _rel(x.numpy(), want.numpy()) < 1e-5


def test_panel_sweep_flags_need_whole_panels():
    for npad in (0, 100, 200):
        with pytest.raises(ValueError, match="multiple of 128"):
            ll.panel_sweep_flags(npad, "cpu")


def test_sweep_wrapper_checks():
    Lp = torch.eye(256)
    with pytest.raises(ValueError, match="tile"):
        ll.bwd_sweep_panels(Lp, torch.ones(256), torch.eye(100)[None])
    with pytest.raises(ValueError):
        ll.bwd_sweep_blocks(Lp, torch.ones(255), torch.eye(128).repeat(
            2, 1, 1))
    with pytest.raises(TypeError):
        ll.bwd_sweep_blocks(Lp, torch.ones(256, dtype=torch.float64),
                            torch.eye(128).repeat(2, 1, 1))


def _unit_lower_blocks(rng, npad, w):
    """A random unit-lower Lp (npad, npad) and the inverses of its w-wide
    diagonal superblocks, float64 numpy arrays."""
    Lp = (np.tril(rng.standard_normal((npad, npad)), -1) / np.sqrt(npad)
          + np.eye(npad))
    invb = np.stack([np.linalg.inv(Lp[k:k + w, k:k + w])
                     for k in range(0, npad, w)])
    return Lp, invb


@pytest.mark.parametrize("npad,w", [(512, 256), (768, 256), (512, 512)])
def test_block_solves_with_zero_pivots_match_jax(rng, npad, w):
    """Pivots that are exactly zero divide by 1 on the way into the
    superblock sweep: the finishing half and the full solve against the
    JAX package's on the same factors, float64."""
    Lp, invb = _unit_lower_blocks(rng, npad, w)
    d = rng.standard_normal(npad)
    d[[1, npad // 3, npad - 5]] = 0.0
    y = rng.standard_normal(npad - 40)
    got = TL.ldlt_solve_blocks_bwd(_T(Lp), _T(d), _T(invb), _T(y)).numpy()
    want = JL.ldlt_solve_blocks_bwd(jnp.asarray(Lp), jnp.asarray(d),
                                    jnp.asarray(invb), jnp.asarray(y))
    assert got.shape == want.shape and _rel(got, want) < 1e-10
    z = np.pad(y, (0, 40)) / np.where(d != 0, d, 1.0)
    assert _rel(ll.bwd_sweep_ref(_T(Lp), _T(z), _T(invb)).numpy()[:y.size],
                want) < 1e-10
    got = TL.ldlt_solve_blocks(_T(Lp), _T(d), _T(invb), _T(y)).numpy()
    want = JL.ldlt_solve_blocks(jnp.asarray(Lp), jnp.asarray(d),
                                jnp.asarray(invb), jnp.asarray(y), block=w)
    assert _rel(got, want) < 1e-10


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
@pytest.mark.parametrize("at", [0, 255, 256, 600, 767])
def test_bwd_sweep_ref_keeps_non_finite(rng, at, bad):
    """A non-finite entry of z leaves x non-finite at that entry and
    wherever the JAX sweep is (the solver's NaN guard reads x)."""
    Lp, invb = _unit_lower_blocks(rng, 768, 256)
    z = rng.standard_normal(768)
    z[at] = bad
    x = ll.bwd_sweep_blocks(_T(Lp), _T(z), _T(invb)).numpy()
    want = np.asarray(JL._bwd_sweep_xla(jnp.asarray(Lp), jnp.asarray(z),
                                        jnp.asarray(invb)))
    assert not np.isfinite(x[at])
    np.testing.assert_array_equal(np.isfinite(x), np.isfinite(want))


@pytest.mark.parametrize("npad,w", [(128, 128), (2048, 1024), (5120, 1024),
                                    (5120, 128), (4096, 4096)])
def test_blocks_sweep_scratch(npad, w):
    """The one-launch superblock sweep's scratch: two zeroed int32
    counters per 128-group of x, and one 128-vector of the working type
    per tile of work (g^2 per superblock of x partials, (n - 1) g^2 of slab
    partials)."""
    n, g = npad // w, w // 128
    for dtype in (torch.float32, torch.float64):
        counts, partials = ll.blocks_sweep_scratch(npad, w, dtype, "cpu")
        assert counts.dtype == torch.int32 and not bool(counts.any())
        assert tuple(counts.shape) == (2 * n * g,)
        assert partials.dtype == dtype
        assert tuple(partials.shape) == (n * g * g * 128 * n,)


def test_blocks_sweep_scratch_needs_whole_tiles():
    for npad, w in ((600, 200), (512, 0), (1024, 384), (0, 128)):
        with pytest.raises(ValueError, match="multiple of 128"):
            ll.blocks_sweep_scratch(npad, w, torch.float32, "cpu")


# ----------------------------------------------------------------------
# the factorizations, float64
@pytest.mark.parametrize("K", SIZES)
def test_ldlt_factor_matches_jax(rng, K):
    """rhs, pad_to and want_panels together, and the plain form."""
    A = _indef(rng, K)
    b = rng.standard_normal(K)
    npad = -(-K // 128) * 128 + 256
    want = JL.ldlt_factor(jnp.asarray(A), rhs=jnp.asarray(b), pad_to=npad,
                          want_panels=True)
    got = TL.ldlt_factor(_T(A), rhs=_T(b), pad_to=npad, want_panels=True)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w, name in zip(got, want, ("L", "d", "y", "panels")):
        assert _rel(g.numpy(), w) < 1e-10, name
    L, d = TL.ldlt_factor(_T(A))
    Lj, dj = JL.ldlt_factor(jnp.asarray(A))
    assert _rel(L.numpy(), Lj) < 1e-10 and _rel(d.numpy(), dj) < 1e-10
    np.testing.assert_array_equal(d.numpy() < 0, np.asarray(dj) < 0)


@pytest.mark.parametrize("K", SIZES)
def test_ldlt_factor_blocks_and_panels_match_jax(rng, K):
    A = _indef(rng, K)
    b = rng.standard_normal(K)
    want = JL.ldlt_factor_blocks(jnp.asarray(A), block=128, group=4,
                                 rhs=jnp.asarray(b), pad_to_grid=True)
    got = TL.ldlt_factor_blocks(_T(A), block=128, group=4, rhs=_T(b))
    for g, w, name in zip(got, want, ("L", "d", "invb", "y")):
        assert g.shape == w.shape and _rel(g.numpy(), w) < 1e-10, name
    want = JL.ldlt_factor_panels(jnp.asarray(A), block=128, group=8,
                                 rhs=jnp.asarray(b))
    got = TL.ldlt_factor_panels(_T(A), block=128, group=8, rhs=_T(b))
    for g, w, name in zip(got, want, ("Lp", "dp", "invp", "y")):
        assert g.shape == w.shape and _rel(g.numpy(), w) < 1e-10, name


@pytest.mark.parametrize("K", SIZES)
def test_large_solves_match_numpy(rng, K):
    """Every solve form against a dense solve, and the folded-forward
    finishes against the full solves."""
    A = _rand_sym(rng, K, K)
    b = rng.standard_normal(K)
    ref = np.linalg.solve(A, b)
    L, d, invb, yf = TL.ldlt_factor_blocks(_T(A), group=4, rhs=_T(b))
    for x in (TL.ldlt_solve_blocks(L, d, invb, _T(b)),
              TL.ldlt_solve_blocks_bwd(L, d, invb, yf)[:K]):
        assert _rel(x.numpy(), ref) < 1e-12
    Lp, dp, invp, yp = TL.ldlt_factor_panels(_T(A), rhs=_T(b))
    for x in (TL.ldlt_solve_panels(Lp, dp, invp, _T(b)),
              TL.ldlt_solve_panels_bwd(Lp, dp, invp, yp)[:K]):
        assert _rel(x.numpy(), ref) < 1e-12


def test_unit_lower_inverse_exact(rng):
    for n in (5, 16, 33, 128):
        L = np.tril(rng.standard_normal((n, n)), -1) / n + np.eye(n)
        Linv = TL.unit_lower_inverse(_T(L)).numpy()
        np.testing.assert_allclose(Linv @ L, np.eye(n), atol=1e-12)
        assert _rel(Linv, JL.unit_lower_inverse(jnp.asarray(L))) < 1e-12


# ----------------------------------------------------------------------
# reg_solve_kkt, K > 128, float64
def _saddle(rng, D, M, neg_w, rank_def=False):
    """[[W, Je], [Je', 0]] with ``neg_w`` negative eigenvalues of W; with
    ``rank_def`` Je has two repeated columns (a singular eq block)."""
    Q = np.linalg.qr(rng.standard_normal((D, D)))[0]
    w = np.linspace(1.0, 3.0, D)
    w[:neg_w] *= -1
    Je = rng.standard_normal((D, M))
    if rank_def:
        Je[:, 1] = Je[:, 0]
        Je[:, 3] = Je[:, 2]
    H = np.zeros((D + M, D + M))
    H[:D, :D] = (Q * w) @ Q.T
    H[:D, D:] = Je
    H[D:, :D] = Je.T
    return (H + H.T) / 2


def _reg_both(H, g, delta, mu, D, M, want_solver):
    cfg = JCfg(float_dtype="float64")
    kw = dict(nvar=D, neq=M, nineq=0, eps=cfg.eps, reg_coef=cfg.reg_coef,
              eta=cfg.eta, beta=cfg.beta, delta0=cfg.delta0, max_retries=40)
    rhs2 = np.cos(np.arange(H.shape[0]) + 1.0)

    @jax.jit
    def jax_one(H_, g_, dl_, mu_):
        out = JL.reg_solve_kkt(H_, g_, dl_, mu_, method="ldlt",
                               want_solver=want_solver, **kw)
        if want_solver:
            return out[:3] + (out[3](jnp.asarray(rhs2)),) + tuple(out[4])
        return out

    want = [np.asarray(o) for o in jax_one(
        jnp.asarray(H), jnp.asarray(g), jnp.asarray(delta), jnp.asarray(mu))]
    got = TL.reg_solve_kkt(_T(H)[None], _T(g)[None],
                           _T(np.float64(delta))[None],
                           _T(np.float64(mu))[None], want_solver=want_solver,
                           **kw)
    if want_solver:
        dz, dn, rt, apply_factors, (d_app, e_app) = got
        got = (dz, dn, rt, apply_factors(_T(rhs2)[None]), d_app, e_app)
    return [g_[0].numpy() for g_ in got], want


CASES = {
    "healthy": dict(neg_w=0),
    "wrong_inertia": dict(neg_w=5),
    "warm_started": dict(neg_w=0, delta=2e-2),
    "rank_deficient_je": dict(neg_w=0, rank_def=True),
}


def _bkw(H, dz, g, delta, eq, D):
    """Normwise backward error of dz against H + delta I_x - eq I_eq."""
    K = H.shape[0]
    Hs = H.copy()
    idx = np.arange(K)
    Hs[idx, idx] += np.where(idx < D, float(delta), -float(eq))
    dz = np.asarray(dz, np.float64)
    return (np.linalg.norm(Hs @ dz - g)
            / (np.linalg.norm(Hs) * np.linalg.norm(dz) + np.linalg.norm(g)))


@pytest.mark.parametrize("want_solver", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("K", SIZES)
def test_reg_solve_kkt_large_matches_jax(K, case, want_solver):
    """Equal retries, delta_new and applied shifts; dz and a further solve
    through the final factors to 1e-10.  With a singular eq block the
    system solved is regularized by ~6e-13 only, so roundoff moves dz by
    up to ~1e-3 relative: there both directions are held to a backward
    error of 1e-12 against the regularized system instead."""
    spec = dict(CASES[case])
    delta = spec.pop("delta", 0.0)
    rng = np.random.default_rng(K)
    M = 16
    D = K - M
    H = _saddle(rng, D, M, **spec)
    g = rng.standard_normal(K)
    got, want = _reg_both(H, g, delta, 0.1, D, M, want_solver)
    assert int(got[2]) == int(want[2]), (int(got[2]), int(want[2]))
    np.testing.assert_allclose(got[1], want[1], rtol=1e-12)
    if want_solver:
        np.testing.assert_allclose(got[4], want[4], rtol=1e-12)
        np.testing.assert_allclose(got[5], want[5], rtol=1e-12)
    if case == "wrong_inertia":
        assert float(want[1]) > 0.0
    if case == "rank_deficient_je":
        assert float(want[1]) > 0.0                     # escalated
        if want_solver:
            assert float(want[5]) > 0.0                 # eq-block shift
            for dz in (got[0], want[0]):
                assert _bkw(H, dz, g, want[4], want[5], D) < 1e-12
        return
    assert _rel(got[0], want[0]) < 1e-10
    if want_solver:
        assert _rel(got[3], want[3]) < 1e-10


@pytest.mark.parametrize("shape", [(300, 200), (200, 300)])
def test_lstsq_minnorm_large_normal_matrix_matches_jax(rng, shape):
    """k = 200 > 128: the LU branch of both packages."""
    A = rng.standard_normal(shape)
    b = rng.standard_normal(shape[0])
    want = np.asarray(JL.lstsq_minnorm(jnp.asarray(A), jnp.asarray(b)))
    got = TL.lstsq_minnorm(_T(A)[None], _T(b)[None])[0].numpy()
    assert _rel(got, want) < 1e-10
