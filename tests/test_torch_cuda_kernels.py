"""The hand-written CUDA kernels of pyipm_tpu_torch/csrc/small_ldlt.cu
against their plain PyTorch versions, on the card.

Imports torch and numpy only, so it runs on the card's machine, which has
no JAX: ``python -m pytest --noconftest tests/test_torch_cuda_kernels.py``.
Elsewhere every test skips: a CUDA kernel has no CPU mode.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
