"""The hand-written CUDA kernels of pyipm_tpu_torch/csrc (small_ldlt.cu,
panel_ldlt.cu, bwd_sweep_panels.cu, bwd_sweep.cu) against their plain
PyTorch versions, on the card.

Imports torch and numpy only, so it runs on the card's machine, which has
no JAX: ``python -m pytest --noconftest tests/test_torch_cuda_kernels.py``.
Elsewhere every test skips: a CUDA kernel has no CPU mode.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyipm_tpu_torch.ops import large_ldlt as ll  # noqa: E402
from pyipm_tpu_torch.ops import linalg as lin  # noqa: E402
from pyipm_tpu_torch.ops import small_ldlt as sl  # noqa: E402

SHAPES = [(10000, 16), (10000, 36), (129, 36), (1, 16), (512, 128)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda:0")


def _rand_sym(rng, B, n):
    A = rng.standard_normal((B, n, n))
    return (A + np.swapaxes(A, 1, 2)) / 2 + np.eye(n) * (n / 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("B,n", SHAPES)
def test_kernels_match_plain(card, dtype, B, n):
    """Identical pivots (same arithmetic, no FMA contraction) and solves
    within the reduction-order tolerance: f32 rtol 2e-3 / atol 6e-3 as
    test_pallas_ldlt.py:54-56, f64 1e-10."""
    rng = np.random.default_rng(42)
    dt = getattr(torch, dtype)
    A = torch.as_tensor(_rand_sym(rng, B, n), dtype=dt, device=card)
    b = torch.as_tensor(rng.standard_normal((B, n)), dtype=dt, device=card)
    n0 = dict(sl.LAUNCHES)
    L, d = sl.ldlt_factor_small(A)
    Lr, dr = sl.ldlt_factor_small_ref(A)
    x = sl.ldlt_solve_small(Lr, dr, b)
    xr = sl.ldlt_solve_small_ref(Lr, dr, b)
    torch.cuda.synchronize()
    assert sl.LAUNCHES["factor"] == n0["factor"] + 1
    assert sl.LAUNCHES["solve"] == n0["solve"] + 1
    assert torch.equal(d < 0, dr < 0)
    assert torch.equal(d, dr) and torch.equal(L, Lr)
    tol = dict(rtol=2e-3, atol=6e-3) if dtype == "float32" else dict(
        rtol=1e-10, atol=1e-10 * float(xr.abs().max()))
    torch.testing.assert_close(x, xr, **tol)


@pytest.mark.cuda
def test_kernel_rejects_bad_input_on_the_card(card):
    A = torch.eye(4, device=card).repeat(2, 1, 1)
    with pytest.raises(TypeError):
        sl.ldlt_factor_small(A.half())
    with pytest.raises(ValueError):
        sl.ldlt_solve_small(A, torch.ones(2, 4, device=card),
                            torch.ones(2, 4, device="cpu"))


def _zero_pivot_panel(n):
    """Exact-arithmetic panel with zero pivots (see
    test_torch_large_ldlt.py); at n < 5 the zero pivots wrap around."""
    rng = np.random.default_rng(n)
    Lr = np.tril(rng.integers(-1, 2, (n, n)), -1) + np.eye(n)
    d = rng.choice([1.0, -1.0, 2.0, -2.0], n)
    d[np.array([1, n // 3, n - 5]) % n] = 0.0
    A = (Lr * np.where(d != 0, d, 1.0)) @ Lr.T
    A[d == 0, d == 0] -= 1.0
    return A


def _indef_panel(rng, n):
    """Symmetric indefinite, a dominant diagonal of alternating sign."""
    sgn = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    return 0.5 * _rand_sym(rng, 1, n)[0] + np.diag(sgn * n)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "indef", "zero_pivot"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [1, 2, 31, 33, 64, 100, 127, 128])
def test_panel_kernel_bitwise_equal_to_plain(card, n, dtype, kind):
    """Same arithmetic, no FMA contraction: bitwise equal L and d, at
    sizes that fill the kernel's register layout (16 warps x 8 columns,
    32 lanes x 4 rows) partly, exactly and by one short."""
    rng = np.random.default_rng(n)
    A = {"random": lambda: _rand_sym(rng, 1, n)[0],
         "indef": lambda: _indef_panel(rng, n),
         "zero_pivot": lambda: _zero_pivot_panel(n)}[kind]()
    A = torch.as_tensor(A, dtype=getattr(torch, dtype), device=card)
    n0 = ll.LAUNCHES["panel_ldlt"]
    L, d = ll.panel_ldlt(A)
    Lr, dr = ll.panel_ldlt_ref(A)
    torch.cuda.synchronize()
    assert ll.LAUNCHES["panel_ldlt"] == n0 + 1
    assert torch.equal(L, Lr) and torch.equal(d, dr)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("K", [1900, 4352])
def test_sweep_kernels_match_plain(card, K, dtype):
    """Both sweeps on real factors (npad 2048 and 5120): f32 within 1e-5,
    f64 within 1e-10 relative, and the same bits on 20 more calls."""
    rng = np.random.default_rng(K)
    dt = getattr(torch, dtype)
    A = torch.as_tensor(_rand_sym(rng, 1, K)[0] + K * np.eye(K), dtype=dt,
                        device=card)
    Lp, _, invp = lin.ldlt_factor_panels(A)
    Lb, _, invb = lin.ldlt_factor_blocks(A, group=8, pad_to_grid=True)
    z = torch.as_tensor(rng.standard_normal(Lp.shape[0]), dtype=dt,
                        device=card)
    tol = 1e-5 if dtype == "float32" else 1e-10
    for name, fn, L, inv in (("bwd_sweep_panels", ll.bwd_sweep_panels,
                              Lp, invp),
                             ("bwd_sweep_blocks", ll.bwd_sweep_blocks,
                              Lb, invb)):
        n0 = ll.LAUNCHES[name]
        x = fn(L, z, inv)
        xr = ll.bwd_sweep_ref(L, z, inv)
        again = [fn(L, z, inv) for _ in range(20)]
        torch.cuda.synchronize()
        assert ll.LAUNCHES[name] == n0 + 21
        err = float(torch.linalg.vector_norm(x - xr)
                    / torch.linalg.vector_norm(xr))
        assert err <= tol, (name, err)
        assert all(torch.equal(x, x2) for x2 in again), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("npad", [128, 256, 2048, 5120])
def test_panel_sweep_kernel_one_launch(card, npad, dtype):
    """The one-launch panel sweep on a random unit-lower factor: within
    1e-5 (f32) or 1e-10 (f64) relative of the plain sweep, bitwise equal
    over 20 repeated calls (a missing fence or an unordered sum would show),
    one counted launch per call."""
    rng = np.random.default_rng(npad)
    Lp = (np.tril(rng.standard_normal((npad, npad)), -1) / np.sqrt(npad)
          + np.eye(npad))
    invp = np.stack([np.linalg.inv(Lp[k:k + 128, k:k + 128])
                     for k in range(0, npad, 128)])
    dt = getattr(torch, dtype)
    Lp, invp, z = (torch.as_tensor(a, dtype=dt, device=card) for a in (
        Lp, invp, rng.standard_normal(npad)))
    n0 = ll.LAUNCHES["bwd_sweep_panels"]
    xs = [ll.bwd_sweep_panels(Lp, z, invp) for _ in range(20)]
    n1 = ll.LAUNCHES["bwd_sweep_panels"]
    xr = ll.bwd_sweep_ref(Lp, z, invp)
    torch.cuda.synchronize()
    assert n1 == n0 + 20
    err = float(torch.linalg.vector_norm(xs[0] - xr)
                / torch.linalg.vector_norm(xr))
    assert err <= (1e-5 if dtype == "float32" else 1e-10), err
    assert all(torch.equal(xs[0], x) for x in xs[1:])


@pytest.mark.cuda
def test_large_kernels_reject_bad_input_on_the_card(card):
    with pytest.raises(ValueError):
        ll.panel_ldlt(torch.eye(129, device=card))
    with pytest.raises(ValueError):
        ll.bwd_sweep_panels(torch.eye(256, device=card),
                            torch.ones(256, device="cpu"),
                            torch.eye(128, device=card).repeat(2, 1, 1))
