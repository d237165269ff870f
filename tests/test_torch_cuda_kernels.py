"""The hand-written CUDA kernels of pyipm_tpu_torch/csrc (small_ldlt.cu,
panel_ldlt.cu, bwd_sweep_panels.cu, bwd_sweep_blocks.cu)
against their plain PyTorch versions, on the card.

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


RESIDUAL_C = 2.0
PIVOT_FLOOR = 1e-2


def _solve_backward_error(L, d, b, x):
    """Per instance, max_i |L D L^T x - b|_i / (n eps (|L||D||L^T||x| +
    |b|)_i), evaluated in float64; eps of the working type.  Substitution
    in any fixed order keeps it below a small constant (measured ~0.15)."""
    n = L.shape[-1]
    eps = torch.finfo(L.dtype).eps
    Ld, dd, xd, bd = L.double(), d.double(), x.double(), b.double()
    M = (Ld * dd[:, None, :]) @ Ld.mT
    Ma = (Ld.abs() * dd.abs()[:, None, :]) @ Ld.abs().mT
    r = (torch.einsum("bij,bj->bi", M, xd) - bd).abs()
    s = torch.einsum("bij,bj->bi", Ma, xd.abs()) + bd.abs()
    return (r / (n * eps * s)).amax(dim=1)


def _assert_solve_close(L, d, b, x, xr, dtype):
    """The kernel subtracts its products one by one, the plain version sums
    a row first, so the two differ by roundoff.  Held to the plain version
    within f32 rtol 2e-3 / atol 6e-3 (test_pallas_ldlt.py:54-56; f64
    1e-10).  An f32 instance with a pivot below PIVOT_FLOOR amplifies the
    roundoff of both: there, and only there, twice the plain version's own
    distance from the float64 solve of the same factors is added.  And
    every instance is held to the backward-error bound with c =
    RESIDUAL_C."""
    x64 = sl.ldlt_solve_small_ref(L.double(), d.double(), b.double())
    own = (xr.double() - x64).abs().amax(dim=1, keepdim=True)
    rtol, atol = (2e-3, 6e-3) if dtype == "float32" else (
        1e-10, 1e-10 * float(xr.abs().max()))
    ill = (d.abs().amin(dim=1) < PIVOT_FLOOR)[:, None]
    own = own * ill if dtype == "float32" else torch.zeros_like(own)
    excess = (x - xr).abs().double() - (atol + rtol * xr.abs().double()
                                        + 2 * own)
    assert float(excess.max()) <= 0, float(excess.max())
    c = float(_solve_backward_error(L, d, b, x).max())
    assert c <= RESIDUAL_C, c


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("B,n", SHAPES)
def test_kernels_match_plain(card, dtype, B, n):
    """Identical pivots (same arithmetic, no FMA contraction) and solves
    within the summation-order tolerance of ``_assert_solve_close``."""
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
    _assert_solve_close(Lr, dr, b, x, xr, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 31, 32, 33, 64, 69, 95, 97, 100,
                               127, 128])
def test_solve_kernel_sizes_scale_repeatable(card, n, dtype, scaled):
    """Every lane layout of the solve kernel (half-warps at n <= 16; 1 to
    4 entries per lane above), a batch that fills no CTA evenly (at the odd
    sizes from 69 most CTAs' factors start off a 16-byte boundary), with
    and without the row scale: against the plain version, bitwise equal over
    20 calls, and with ``scale`` bitwise what the kernel gives when both
    products are taken outside."""
    rng = np.random.default_rng(n)
    dt = getattr(torch, dtype)
    B = 1003 if n <= 36 else 203
    A = torch.as_tensor(_rand_sym(rng, B, n), dtype=dt, device=card)
    b = torch.as_tensor(rng.standard_normal((B, n)), dtype=dt, device=card)
    sc = torch.as_tensor(rng.uniform(0.25, 4.0, (B, n)), dtype=dt,
                         device=card) if scaled else None
    L, d = sl.ldlt_factor_small(A)
    n0 = sl.LAUNCHES["solve"]
    xs = [sl.ldlt_solve_small(L, d, b, scale=sc) for _ in range(21)]
    assert sl.LAUNCHES["solve"] == n0 + 21
    xr = sl.ldlt_solve_small_ref(L, d, b, sc)
    torch.cuda.synchronize()
    assert all(torch.equal(xs[0], x) for x in xs[1:])
    if scaled:
        outside = sc * sl.ldlt_solve_small(L, d, sc * b)
        assert torch.equal(xs[0], outside)
        # the same system with the scale folded into the operands
        _assert_solve_close(L, d, sc * b, xs[0] / sc, xr / sc, dtype)
    else:
        _assert_solve_close(L, d, b, xs[0], xr, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_solve_kernel_unaligned_factors(card, dtype):
    """Factors that start off a 16-byte boundary (a slice of a batch at
    n = 5) are staged from a scalar head, then 16-byte words: the same bits
    as the aligned copy."""
    rng = np.random.default_rng(5)
    dt = getattr(torch, dtype)
    A = torch.as_tensor(_rand_sym(rng, 77, 5), dtype=dt, device=card)
    b = torch.as_tensor(rng.standard_normal((77, 5)), dtype=dt, device=card)
    L, d = sl.ldlt_factor_small(A)
    assert L[1:].data_ptr() % 16 and L[1:].is_contiguous()
    x = sl.ldlt_solve_small(L[1:], d[1:], b[1:])
    assert torch.equal(x, sl.ldlt_solve_small(L[1:].clone(), d[1:].clone(),
                                              b[1:].clone()))
    assert torch.equal(x, sl.ldlt_solve_small(L, d, b)[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [65, 67, 80, 96, 97, 128])
def test_solve_kernel_wide(card, n, dtype, scaled):
    """The wide solve (64 < n <= 128: a warp an instance, its factor's
    strict lower triangle staged packed) at phase 16's sizes and the bucket
    edges, on the batch slice [1:] of 2,049 instances (off a 16-byte
    boundary at odd n), half of them indefinite: against the plain version,
    bitwise what the same instances give in the whole batch and over 20
    calls, with ``scale`` bitwise the products taken outside; one counted
    launch a call, counted by n."""
    rng = np.random.default_rng(3000 + n)
    dt = getattr(torch, dtype)
    A = _rand_sym(rng, 2049, n)
    A[::2] -= (n / 2) * np.eye(n)
    A = torch.as_tensor(A, dtype=dt, device=card)
    b = torch.as_tensor(rng.standard_normal((2049, n)), dtype=dt,
                        device=card)
    sc = torch.as_tensor(rng.uniform(0.25, 4.0, (2049, n)), dtype=dt,
                         device=card) if scaled else None
    L, d = sl.ldlt_factor_small(A)
    Ls, ds, bs = L[1:], d[1:], b[1:]
    scs = None if sc is None else sc[1:]
    n0, by_n0 = sl.LAUNCHES["solve"], sl.LAUNCHES_BY_N["solve", n]
    xs = [sl.ldlt_solve_small(Ls, ds, bs, scale=scs) for _ in range(21)]
    assert sl.LAUNCHES["solve"] == n0 + 21
    assert sl.LAUNCHES_BY_N["solve", n] == by_n0 + 21
    whole = sl.ldlt_solve_small(L, d, b, scale=sc)
    xr = sl.ldlt_solve_small_ref(Ls, ds, bs, scs)
    torch.cuda.synchronize()
    assert all(torch.equal(xs[0], x) for x in xs[1:])
    assert torch.equal(xs[0], whole[1:])
    if scaled:
        assert torch.equal(xs[0], scs * sl.ldlt_solve_small(Ls, ds,
                                                            scs * bs))
        _assert_solve_close(Ls, ds, scs * bs, xs[0] / scs, xr / scs, dtype)
    else:
        _assert_solve_close(Ls, ds, bs, xs[0], xr, dtype)


@pytest.mark.cuda
def test_solve_kernel_wide_residency(card):
    """More instances resident an SM than the single-warp CTAs of the
    staged full tile allowed (6 at n = 97 in f32), at every wide size."""
    for n, least in ((65, 24), (80, 16), (97, 12), (128, 6)):
        warps, ctas = sl.solve_residency(n, torch.float32, card)
        assert warps * ctas >= least, (n, warps, ctas)


def _same_bits(a, b):
    """Bitwise equal, NaN payloads aside: NaN at the same entries, every
    other entry with the same bits (so -0.0 differs from 0.0)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    it = torch.int32 if a.dtype == torch.float32 else torch.int64
    return (a.dtype == b.dtype and torch.equal(na, nb)
            and torch.equal(a.view(it)[~na], b.view(it)[~nb]))


FACTOR_SIZES = [1, 2, 15, 16, 17, 31, 32, 33, 36, 48, 49, 63, 64, 65, 69, 80,
                95, 96, 97, 127, 128]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", FACTOR_SIZES)
def test_factor_kernel_sizes_repeatable(card, n, dtype):
    """Every size bucket of the factor kernel (half-warps to n = 16, a warp
    to 32, 48 and 64, a lane holding one or two rows; above, the wide
    branch's buckets 96 and 128, a CTA of warps per instance) and their
    edges, at a batch that fills no CTA evenly, half the instances
    indefinite: bitwise the plain version, bitwise repeatable over 20
    calls, one counted launch per call."""
    rng = np.random.default_rng(1000 + n)
    B = 1003 if n <= 36 else 203
    A = _rand_sym(rng, B, n)
    A[::2] -= (n / 2) * np.eye(n)
    A = torch.as_tensor(A, dtype=getattr(torch, dtype), device=card)
    n0 = sl.LAUNCHES["factor"]
    outs = [sl.ldlt_factor_small(A) for _ in range(21)]
    Lr, dr = sl.ldlt_factor_small_ref(A)
    torch.cuda.synchronize()
    assert sl.LAUNCHES["factor"] == n0 + 21
    L, d = outs[0]
    assert bool((dr < 0).any()) and bool((dr > 0).any())
    assert _same_bits(L, Lr) and _same_bits(d, dr)
    assert all(_same_bits(L, L2) and _same_bits(d, d2) for L2, d2 in outs[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [65, 97, 128])
def test_factor_kernel_wide_many_waves(card, n, dtype):
    """The wide branch at B = 2,048, phase 16's bucket batch: more CTAs
    than stay resident at once (several waves), half the instances
    indefinite; bitwise the plain version, one counted launch."""
    rng = np.random.default_rng(2000 + n)
    A = _rand_sym(rng, 2048, n)
    A[::2] -= (n / 2) * np.eye(n)
    A = torch.as_tensor(A, dtype=getattr(torch, dtype), device=card)
    n0 = sl.LAUNCHES["factor"]
    L, d = sl.ldlt_factor_small(A)
    Lr, dr = sl.ldlt_factor_small_ref(A)
    torch.cuda.synchronize()
    assert sl.LAUNCHES["factor"] == n0 + 1
    assert _same_bits(L, Lr) and _same_bits(d, dr)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [5, 65, 69, 97, 127, 128])
def test_factor_kernel_unaligned_slice(card, n, dtype):
    """A batch slice A[1:] starts off a 16-byte boundary: staged from a
    scalar head, then 16-byte words; the same bits as its contiguous
    copy and as the plain version.  Where an instance fills whole 16-byte
    words (n = 128) the batch starts one entry into its storage, so that
    the slice still starts off the boundary."""
    rng = np.random.default_rng(n)
    dt = getattr(torch, dtype)
    A0 = torch.as_tensor(_rand_sym(rng, 41, n), dtype=dt, device=card)
    off = int(n * n * A0.element_size() % 16 == 0)
    A = torch.empty(A0.numel() + off, dtype=dt, device=card)[off:]
    A = A.view(41, n, n)
    A.copy_(A0)
    assert A[1:].data_ptr() % 16 and A[1:].is_contiguous()
    L, d = sl.ldlt_factor_small(A[1:])
    L2, d2 = sl.ldlt_factor_small(A[1:].clone())
    Lr, dr = sl.ldlt_factor_small_ref(A[1:])
    assert _same_bits(L, L2) and _same_bits(d, d2)
    assert _same_bits(L, Lr) and _same_bits(d, dr)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind", ["zero_pivot", "nan", "inf"])
def test_factor_kernel_special_values(card, kind, dtype):
    """Exact zero pivots (divided by 1), a NaN and an Inf entry (a NaN
    pivot divides by 1 too): bitwise the plain version, NaNs at the same
    entries, at a size of each bucket."""
    dt = getattr(torch, dtype)
    if kind == "zero_pivot":
        cases = [np.array([[[0.0, 1.0, 2.0], [1.0, 0.0, 3.0],
                            [2.0, 3.0, 1.0]],
                           [[4.0, 2.0, 0.0], [2.0, 1.0, 5.0],
                            [0.0, 5.0, 2.0]]])]
        cases += [_zero_pivot_panel(n)[None] for n in (16, 36, 65, 100, 128)]
    else:
        bad = float("nan") if kind == "nan" else float("inf")
        cases = []
        for n in (5, 16, 36, 64, 65, 100, 128):
            A = _rand_sym(np.random.default_rng(n), 6, n)
            A[2, n // 2, min(1, n - 1)] = bad       # below the diagonal
            A[4, 0, 0] = bad                        # the first pivot
            cases.append(A)
    for A in cases:
        A = torch.as_tensor(A, dtype=dt, device=card)
        L, d = sl.ldlt_factor_small(A)
        Lr, dr = sl.ldlt_factor_small_ref(A)
        assert _same_bits(L, Lr) and _same_bits(d, dr), A.shape
        if kind != "zero_pivot":
            assert not bool(torch.isfinite(d).all())


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
@pytest.mark.parametrize("B", [1, 131, 132, 133, 256, 264, 1024])
def test_panel_kernel_batched_bitwise(card, B, dtype):
    """A batch of 128-panels (random, indefinite and exact-zero-pivot) at
    the edges of one and two panels an SM: bitwise equal to the plain
    version panel by panel, one counted launch by B, whichever variant
    ``panels_per_sm`` picks."""
    rng = np.random.default_rng(B)
    A = _rand_sym(rng, B, 128)
    A[1::3] = _indef_panel(rng, 128)
    A[2::7] = _zero_pivot_panel(128)
    A = torch.as_tensor(A, dtype=getattr(torch, dtype), device=card)
    n0, by_b0 = ll.LAUNCHES["panel_ldlt"], ll.LAUNCHES_BY_B["panel_ldlt", B]
    L, d = ll.panel_ldlt(A)
    Lr, dr = ll.panel_ldlt_ref(A)
    torch.cuda.synchronize()
    assert ll.LAUNCHES["panel_ldlt"] == n0 + 1
    assert ll.LAUNCHES_BY_B["panel_ldlt", B] == by_b0 + 1
    assert torch.equal(L, Lr) and torch.equal(d, dr)
    for i in (0, B // 2, B - 1):
        Li, di = ll.panel_ldlt_ref(A[i])
        assert torch.equal(L[i], Li) and torch.equal(d[i], di)


@pytest.mark.cuda
def test_panel_kernel_two_panels_an_sm(card):
    """The two-panel variant keeps two 128-panels resident an SM in f32,
    and a batch of more panels than SMs takes it."""
    assert ll.panel_residency(2, torch.float32, card) >= 2
    assert ll.panel_residency(1, torch.float32, card) >= 1
    sms = ll.sm_count(card)
    assert ll.panels_per_sm(sms + 1, sms, torch.float32) == 2


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
    Lb, _, invb = lin.ldlt_factor_blocks(A, group=8)
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
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("npad,w", [(128, 128), (512, 256), (1536, 512),
                                    (2048, 1024), (5120, 1024),
                                    (4096, 4096), (5120, 128)])
def test_block_sweep_kernel_one_launch(card, npad, w, dtype):
    """The one-launch superblock sweep on a random unit-lower factor, from
    one superblock to 40 and from one 128-tile per superblock to 32:
    within 1e-5 (f32) or 1e-10 (f64) relative of the plain sweep, bitwise
    equal over 20 repeated calls, one counted launch per call."""
    rng = np.random.default_rng(npad + w)
    Lp = (np.tril(rng.standard_normal((npad, npad)), -1) / np.sqrt(npad)
          + np.eye(npad))
    invb = np.stack([np.linalg.inv(Lp[k:k + w, k:k + w])
                     for k in range(0, npad, w)])
    dt = getattr(torch, dtype)
    Lp, invb, z = (torch.as_tensor(a, dtype=dt, device=card) for a in (
        Lp, invb, rng.standard_normal(npad)))
    n0 = ll.LAUNCHES["bwd_sweep_blocks"]
    xs = [ll.bwd_sweep_blocks(Lp, z, invb) for _ in range(20)]
    xr = ll.bwd_sweep_ref(Lp, z, invb)
    torch.cuda.synchronize()
    assert ll.LAUNCHES["bwd_sweep_blocks"] == n0 + 20
    err = float(torch.linalg.vector_norm(xs[0] - xr)
                / torch.linalg.vector_norm(xr))
    assert err <= (1e-5 if dtype == "float32" else 1e-10), err
    assert all(torch.equal(xs[0], x) for x in xs[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("w", [128, 1024])
def test_block_sweep_kernel_keeps_non_finite(card, w):
    """A non-finite entry of z reaches x (through the unit diagonal of the
    inverse, whatever tiles above the diagonal are skipped): the solver's
    NaN guard depends on it."""
    npad = 2 * w
    rng = np.random.default_rng(w)
    Lp = (np.tril(rng.standard_normal((npad, npad)), -1) / np.sqrt(npad)
          + np.eye(npad))
    invb = np.stack([np.linalg.inv(Lp[k:k + w, k:k + w])
                     for k in range(0, npad, w)])
    Lp, invb, z = (torch.as_tensor(a, dtype=torch.float32, device=card)
                   for a in (Lp, invb, rng.standard_normal(npad)))
    for at in (0, w - 1, w, npad - 1):
        for bad in (float("nan"), float("inf")):
            zb = z.clone()
            zb[at] = bad
            x = ll.bwd_sweep_blocks(Lp, zb, invb)
            assert not bool(torch.isfinite(x[at])), (at, bad)
            assert not bool(torch.isfinite(x).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_block_sweep_rejects_width_off_128(card, dtype):
    """The kernel works in 128 x 128 tiles: on the card a superblock width
    that is no multiple of 128 raises, and never takes the plain version."""
    npad, w = 600, 200
    dt = getattr(torch, dtype)
    Lp = torch.eye(npad, dtype=dt, device=card)
    invb = torch.eye(w, dtype=dt, device=card).repeat(npad // w, 1, 1)
    n0 = dict(ll.LAUNCHES)
    with pytest.raises(ValueError, match="multiple of 128"):
        ll.bwd_sweep_blocks(Lp, torch.ones(npad, dtype=dt, device=card), invb)
    assert ll.LAUNCHES == n0


@pytest.mark.cuda
def test_large_kernels_reject_bad_input_on_the_card(card):
    with pytest.raises(ValueError):
        ll.panel_ldlt(torch.eye(129, device=card))
    with pytest.raises(ValueError):
        ll.bwd_sweep_panels(torch.eye(256, device=card),
                            torch.ones(256, device="cpu"),
                            torch.eye(128, device=card).repeat(2, 1, 1))
    off = torch.zeros(256 * 256 + 1, device=card)[1:].view(256, 256)
    with pytest.raises(ValueError, match="16-byte"):
        ll.bwd_sweep_blocks(off, torch.ones(256, device=card),
                            torch.eye(128, device=card).repeat(2, 1, 1))


def _kkt_batch(rng, B, K, M):
    """B saddle systems [[W, Je], [Je', 0]] of size K, cycling through a
    healthy W, one with 5 negative eigenvalues (escalated), a warm-started
    delta and an eq block with a zero row (an exact zero pivot: the eq
    regularization on both devices)."""
    D = K - M
    H = np.zeros((B, K, K))
    delta = np.zeros(B)
    for i in range(B):
        Q = np.linalg.qr(rng.standard_normal((D, D)))[0]
        w = np.linspace(1.0, 3.0, D)
        if i % 4 == 1:
            w[:5] *= -1
        Je = rng.standard_normal((D, M))
        if i % 4 == 3:
            Je[:, 0] = 0.0
        H[i, :D, :D] = (Q * w) @ Q.T
        H[i, :D, D:] = Je
        H[i, D:, :D] = Je.T
        delta[i] = 2e-2 if i % 4 == 2 else 0.0
    return (H + np.swapaxes(H, 1, 2)) / 2, rng.standard_normal((B, K)), delta


@pytest.mark.cuda
@pytest.mark.parametrize("want_solver", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_wide_batch_solve_matches_cpu_path(card, dtype, want_solver):
    """``reg_solve_kkt`` on a batch of 8 systems of K = 257 (the batched
    K > 128 body: kernel 3 on the (8, 128, 128) panels) on the card against
    the same call on CPU tensors (the plain panel): retries, delta_new and
    the applied primal shift equal, the eq-block shift where the other
    device applies it and within 4 eps of it, and every direction (and,
    with ``want_solver``, a further solve) within the backward error of a
    stable solve, K eps, against the regularized system."""
    from pyipm_tpu_torch.config import IPMConfig, matmul_precision
    B, K, M = 8, 257, 16
    rng = np.random.default_rng(257)
    H, g, delta = _kkt_batch(rng, B, K, M)
    cfg = IPMConfig(float_dtype=dtype)
    kw = dict(nvar=K - M, neq=M, nineq=0, eps=cfg.eps,
              reg_coef=cfg.reg_coef, eta=cfg.eta, beta=cfg.beta,
              delta0=cfg.delta0, want_solver=want_solver)
    dt = getattr(torch, dtype)
    r2 = rng.standard_normal((B, K))
    out = {}
    for dev in (card, torch.device("cpu")):
        args = [torch.as_tensor(a, dtype=dt, device=dev)
                for a in (H, g, delta, np.full(B, 0.1))]
        n0 = ll.LAUNCHES_BY_B["panel_ldlt", B]
        with matmul_precision(cfg.matmul_precision):
            res = lin.reg_solve_kkt(*args, **kw)
            x2 = (res[3](torch.as_tensor(r2, dtype=dt, device=dev))
                  if want_solver else None)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert ll.LAUNCHES_BY_B["panel_ldlt", B] > n0
        out[dev.type] = [t.cpu() if t is not None else None
                         for t in (*res[:3], x2,
                                   *(res[4] if want_solver else ()))]
    got, ref = out["cuda"], out["cpu"]
    assert torch.equal(got[2], ref[2])
    assert torch.equal(got[1], ref[1])
    assert int(ref[2][1]) > 0
    if want_solver:
        # the primal shift is delta0 times powers of 10 on both devices;
        # the eq-block term reg_coef eta mu^beta goes through each
        # device's pow, which may round its last bit apart
        assert torch.equal(got[4], ref[4])
        assert torch.equal(got[5] > 0, ref[5] > 0)
        torch.testing.assert_close(got[5], ref[5], rtol=4 * torch.finfo(
            dt).eps, atol=0)
        shifts = got[4:]
    else:
        # the shifts the same decisions apply (want_solver only returns them)
        shifts = lin.reg_solve_kkt(*(torch.as_tensor(a, dtype=dt) for a in (
            H, g, delta, np.full(B, 0.1))), **{**kw, "want_solver": True})[4]
    ex = torch.as_tensor(np.arange(K) < K - M, dtype=torch.float64)
    Hd = (torch.as_tensor(H)
          + torch.diag_embed(shifts[0].double()[:, None] * ex)
          - torch.diag_embed(shifts[1].double()[:, None] * (1 - ex)))
    bound = K * torch.finfo(dt).eps
    for x, b in ((got[0], g), (got[3], r2)):
        if x is None:
            continue
        xd, bd = x.double(), torch.as_tensor(b)
        bk = (torch.linalg.vector_norm(
            torch.einsum("bij,bj->bi", Hd, xd) - bd, dim=-1)
            / (torch.linalg.matrix_norm(Hd)
               * torch.linalg.vector_norm(xd, dim=-1)
               + torch.linalg.vector_norm(bd, dim=-1)))
        assert float(bk.max()) <= bound, (float(bk.max()), bound)
