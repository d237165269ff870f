"""The port's batched small LDL^T (pyipm_tpu_torch/ops/small_ldlt.py)
against the JAX package's Pallas kernels and plain-JAX factorizations, on
identical numpy-seeded inputs.

On the CPU the port's wrappers take the plain PyTorch versions; the Pallas
kernel bodies run in interpret mode, as tests/test_pallas_ldlt.py runs
them.  The hand-written CUDA kernels are compared with the plain versions
in tests/test_torch_cuda_kernels.py, on the card.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from pyipm_tpu.config import IPMConfig as JCfg  # noqa: E402
from pyipm_tpu.ops import pallas_ldlt as pk  # noqa: E402
from pyipm_tpu.ops.linalg import ldlt_solve_inv, ldlt_unblocked  # noqa: E402
from pyipm_tpu_torch.ops import linalg as TL  # noqa: E402
from pyipm_tpu_torch.ops import small_ldlt as sl  # noqa: E402


def _rand_sym(rng, B, n):
    A = rng.standard_normal((B, n, n))
    return (A + np.swapaxes(A, 1, 2)) / 2 + np.eye(n) * (n / 4)


# the CUDA factor's warp scheme (n <= 64) and its wide branch (64 < n <= 128)
@pytest.mark.parametrize("B,n", [(128, 16), (130, 36), (128, 48), (128, 65),
                                 (130, 97), (128, 128)])
def test_plain_factor_matches_pallas_kernel(rng, B, n):
    A = _rand_sym(rng, B, n).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        Lk, dk = pk.batched_ldlt_factor(jnp.asarray(A))
    L, d = sl.ldlt_factor_small(torch.as_tensor(A))
    L, d, Lk, dk = L.numpy(), d.numpy(), np.asarray(Lk), np.asarray(dk)
    # tolerances of test_pallas_ldlt.py:33-42; the same right-looking
    # column order, so the pivots agree to f32 accumulation differences
    np.testing.assert_allclose(d, dk, rtol=5e-3, atol=1e-3)
    np.testing.assert_allclose(np.tril(L), np.tril(Lk), rtol=5e-3, atol=1e-3)
    rec = np.einsum("bij,bj,bkj->bik", L, d, L)
    scale = np.max(np.abs(A))
    np.testing.assert_allclose(rec, A, atol=5e-5 * scale * n, rtol=1e-4)
    np.testing.assert_array_equal(d < 0, dk < 0)


@pytest.mark.parametrize("B,n", [(128, 16), (130, 36), (128, 48)])
def test_plain_solve_matches_pallas_kernel(rng, B, n):
    A = _rand_sym(rng, B, n).astype(np.float32)
    b = rng.standard_normal((B, n)).astype(np.float32)
    Lr, dr = jax.vmap(ldlt_unblocked)(jnp.asarray(A))
    with pltpu.force_tpu_interpret_mode():
        xk = np.asarray(pk.batched_ldlt_solve(Lr, dr, jnp.asarray(b)))
    x = sl.ldlt_solve_small(torch.tensor(np.asarray(Lr)),
                            torch.tensor(np.asarray(dr)),
                            torch.as_tensor(b)).numpy()
    # tolerance of test_pallas_ldlt.py:54-56 (reduction order differs)
    np.testing.assert_allclose(x, xk, rtol=2e-3, atol=6e-3)


@pytest.mark.parametrize("B,n", [(8, 16), (8, 36), (4, 48), (4, 1), (6, 17),
                                 (6, 33), (4, 64), (4, 65), (2, 128)])
def test_f64_matches_plain_jax(rng, B, n):
    """float64 against ldlt_unblocked / ldlt_solve_inv, <= 1e-10 relative;
    half the instances made indefinite.  The sizes include the edges of the
    CUDA factor kernel's layouts (half-warps to 16, a warp to 32, 48 and 64,
    the CTA scheme above), where the card tests hold the kernel to
    this plain version bit for bit."""
    A = _rand_sym(rng, B, n)
    A[::2] -= (n / 2) * np.eye(n)
    b = rng.standard_normal((B, n))
    Lr, dr = jax.vmap(ldlt_unblocked)(jnp.asarray(A))
    xr = np.asarray(ldlt_solve_inv(Lr, dr, jnp.asarray(b)))
    Lr, dr = np.asarray(Lr), np.asarray(dr)
    L, d = sl.ldlt_factor_small(torch.as_tensor(A))
    x = sl.ldlt_solve_small(L, d, torch.as_tensor(b)).numpy()
    L, d = L.numpy(), d.numpy()
    np.testing.assert_array_equal(d < 0, dr < 0)
    np.testing.assert_allclose(d, dr, rtol=1e-10, atol=0)
    np.testing.assert_allclose(L, Lr, rtol=1e-10, atol=1e-10 * np.abs(Lr).max())
    np.testing.assert_allclose(x, xr, rtol=1e-10, atol=1e-10 * np.abs(xr).max())


@pytest.mark.parametrize("B,n", [(8, 16), (8, 36), (4, 48), (3, 128)])
def test_scaled_solve_matches_jax(rng, B, n):
    """``ldlt_solve_small(L, d, b, scale=dsc)`` against the JAX package's
    ``dsc * ldlt_solve_small(L, d, dsc * rhs)`` (linalg.py:949-950, vmapped
    on the CPU as the solver runs it), float64, <= 1e-10 relative; and
    bitwise the plain solve with both products taken outside."""
    A = _rand_sym(rng, B, n)
    A[::2] -= (n / 2) * np.eye(n)
    b = rng.standard_normal((B, n))
    dsc = rng.uniform(0.25, 4.0, (B, n))
    Lr, dr = jax.vmap(ldlt_unblocked)(jnp.asarray(A))
    want = np.asarray(jax.vmap(
        lambda L_, d_, s_, r_: s_ * pk.ldlt_solve_small(L_, d_, s_ * r_))(
        Lr, dr, jnp.asarray(dsc), jnp.asarray(b)))
    L, d = torch.tensor(np.asarray(Lr)), torch.tensor(np.asarray(dr))
    bt, st = torch.as_tensor(b), torch.as_tensor(dsc)
    x = sl.ldlt_solve_small(L, d, bt, scale=st)
    np.testing.assert_allclose(x.numpy(), want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())
    assert torch.equal(x, st * sl.ldlt_solve_small(L, d, st * bt))
    assert torch.equal(x, sl.ldlt_solve_small_ref(L, d, bt, st))


@pytest.mark.parametrize("want_solver", [False, True])
@pytest.mark.parametrize("K,M", [(16, 0), (36, 4), (128, 16)])
def test_reg_solve_kkt_unchanged_by_fused_scale(rng, K, M, want_solver,
                                                monkeypatch):
    """``reg_solve_kkt`` at K <= 128 hands its Ruiz scale to the solve; in
    float64 it gives the same bits as with both products taken outside,
    as it computed them before the solve took ``scale``."""
    B, D = 5, K - M
    Q = rng.standard_normal((B, D, D))
    H = np.zeros((B, K, K))
    H[:, :D, :D] = Q @ np.swapaxes(Q, 1, 2) / D + 0.1 * np.eye(D)
    H[::2, 0, 0] -= 3.0                       # wrong inertia: escalates
    Je = rng.standard_normal((B, D, M))
    H[:, :D, D:] = Je
    H[:, D:, :D] = np.swapaxes(Je, 1, 2)
    g = rng.standard_normal((B, K))
    cfg = JCfg(float_dtype="float64")
    kw = dict(nvar=D, neq=M, nineq=0, eps=cfg.eps, reg_coef=cfg.reg_coef,
              eta=cfg.eta, beta=cfg.beta, delta0=cfg.delta0, max_retries=20,
              want_solver=want_solver)
    args = (torch.as_tensor(H), torch.as_tensor(g),
            torch.zeros(B, dtype=torch.float64),
            torch.full((B,), 0.1, dtype=torch.float64))
    rhs2 = torch.as_tensor(np.cos(np.arange(B * K, dtype=np.float64))
                           .reshape(B, K))

    def run():
        out = TL.reg_solve_kkt(*args, **kw)
        if want_solver:
            return out[:3] + (out[3](rhs2),) + tuple(out[4])
        return out

    fused = run()

    def outside(L, d, b, scale=None):
        if scale is None:
            return sl.ldlt_solve_small(L, d, b)
        return scale * sl.ldlt_solve_small(L, d, (scale * b).contiguous())

    monkeypatch.setattr(TL, "ldlt_solve_small", outside)
    for a, b in zip(fused, run()):
        assert torch.equal(a, b)
    assert float(fused[1][0]) > 0.0            # the shift was applied


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "device"])
def test_solve_wrapper_checks_scale(bad):
    L = torch.eye(4, dtype=torch.float64).repeat(2, 1, 1)
    d = torch.ones(2, 4, dtype=torch.float64)
    b = torch.ones(2, 4, dtype=torch.float64)
    if bad == "dtype":
        scale, err = torch.ones(2, 4, dtype=torch.float32), TypeError
    elif bad == "shape":
        scale, err = torch.ones(2, dtype=torch.float64), ValueError
    elif bad == "contiguous":
        scale, err = torch.ones(4, 2, dtype=torch.float64).T, ValueError
    else:
        scale, err = torch.ones(2, 4, dtype=torch.float64,
                                device="meta"), ValueError
    with pytest.raises(err):
        sl.ldlt_solve_small(L, d, b, scale=scale)
    x = sl.ldlt_solve_small(L, d, b, scale=2 * torch.ones_like(b))
    assert torch.equal(x, 4 * b)


def test_zero_pivot_guard_matches_jax():
    """A zero pivot divides by 1 in both the factorization and the
    diagonal scale of the solve, as the Pallas kernels do."""
    A = np.array([[[0.0, 1.0, 2.0], [1.0, 0.0, 3.0], [2.0, 3.0, 1.0]],
                  [[4.0, 2.0, 0.0], [2.0, 1.0, 5.0], [0.0, 5.0, 2.0]]],
                 np.float32)
    b = np.array([[1.0, -1.0, 2.0], [0.5, 1.0, -2.0]], np.float32)
    with pltpu.force_tpu_interpret_mode():
        Lk, dk = pk.batched_ldlt_factor(jnp.asarray(A))
        xk = pk.batched_ldlt_solve(Lk, dk, jnp.asarray(b))
    L, d = sl.ldlt_factor_small(torch.as_tensor(A))
    x = sl.ldlt_solve_small(L, d, torch.as_tensor(b))
    assert float(d[0, 0]) == 0.0 and float(d[1, 1]) == 0.0
    np.testing.assert_array_equal(d.numpy(), np.asarray(dk))
    np.testing.assert_array_equal(np.tril(L.numpy()), np.tril(np.asarray(Lk)))
    np.testing.assert_allclose(x.numpy(), np.asarray(xk), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("B,n", [(130, 16), (130, 36), (128, 65), (130, 97),
                                 (128, 128)])
def test_non_finite_instances_match_pallas_kernel(rng, B, n):
    """A batch in which a few instances hold a NaN or an Inf: the plain
    factor and the Pallas kernel (interpret mode) give a non-finite pivot
    to the same instances, and every other instance is bitwise what
    factoring it alone gives and within the f32 tolerance of the kernel.
    Where NaN lands inside a bad instance is not compared: the Pallas
    kernel masks its update by multiplying, so NaN * 0 reaches finished
    columns, which the port's update does not touch."""
    A = _rand_sym(rng, B, n).astype(np.float32)
    bad = np.array([3, 64, 127])
    A[3, n // 2, 1] = A[3, 1, n // 2] = np.nan
    A[64, 0, 0] = np.inf
    A[127, n - 1, n - 1] = np.nan
    with pltpu.force_tpu_interpret_mode():
        Lk, dk = pk.batched_ldlt_factor(jnp.asarray(A))
    Lk, dk = np.asarray(Lk), np.asarray(dk)
    L, d = sl.ldlt_factor_small(torch.as_tensor(A))
    good = np.setdiff1d(np.arange(B), bad)
    port_bad = np.flatnonzero(~torch.isfinite(d).all(dim=1).numpy())
    kernel_bad = np.flatnonzero(~np.isfinite(dk).all(axis=1))
    np.testing.assert_array_equal(port_bad, bad)
    np.testing.assert_array_equal(kernel_bad, bad)
    L1, d1 = sl.ldlt_factor_small(torch.as_tensor(A[good]))
    assert torch.equal(L[good], L1) and torch.equal(d[good], d1)
    np.testing.assert_allclose(d[good].numpy(), dk[good], rtol=5e-3,
                               atol=1e-3)
    np.testing.assert_allclose(np.tril(L[good].numpy()), np.tril(Lk[good]),
                               rtol=5e-3, atol=1e-3)


def test_cpu_tensors_take_the_plain_versions(rng):
    A = torch.as_tensor(_rand_sym(rng, 3, 5))
    before = dict(sl.LAUNCHES)
    L, d = sl.ldlt_factor_small(A)
    x = sl.ldlt_solve_small(L, d, torch.ones(3, 5, dtype=torch.float64))
    Lr, dr = sl.ldlt_factor_small_ref(A)
    assert torch.equal(L, Lr) and torch.equal(d, dr)
    assert torch.equal(x, sl.ldlt_solve_small_ref(L, d, torch.ones_like(x)))
    assert sl.LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "n"])
def test_wrapper_rejects_what_the_kernels_do_not_take(bad):
    A = torch.eye(4).repeat(2, 1, 1)
    if bad == "dtype":
        A, err = A.to(torch.float16), TypeError
    elif bad == "shape":
        A, err = A[:, :, :3], ValueError
    elif bad == "contiguous":
        A, err = A.transpose(0, 1), ValueError
    else:
        A, err = torch.eye(130).repeat(1, 1, 1), ValueError
    with pytest.raises(err):
        sl.ldlt_factor_small(A)
