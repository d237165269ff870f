"""Drive the PyTorch/CUDA port once on the card, end to end.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: compile every hand-written kernel source of
     pyipm_tpu_torch/csrc, one nvcc per source, all at once;
  3. kernels 1-2 (batched small LDL^T factor and solve) against their
     plain PyTorch versions on the card, f32 and f64; the factor bitwise
     at every size bucket and its edges (n = 1 to 128), half the
     instances indefinite, repeatable over 20 calls, and on an unaligned
     batch slice; the solve at every lane layout (n = 1 to 128), with and
     without its row scale, bitwise repeatable, and against a
     backward-error bound; both timed at (10000, 16) and (10000, 36), the
     factor also at (512, 128);
  4. slice A: the 10,000-QP float32 fleet through ``solve_batch`` on
     cuda:0, launch counters reset just before the timed solve;
  5. the same first 64 instances on CPU tensors (the plain path) against
     the card's results;
  6. kernels 3-5 (panel LDL^T, backward panel and superblock sweeps)
     against their plain versions on the card, f32 and f64: the panel
     bitwise at n = 1 to 128, the sweeps at the K = 4352 factors (npad
     5120) and at K = 1900 (npad 2048), bitwise repeatable, one launch
     per call;
  7. the single-shot K = 4352 KKT factor+solve (``reg_solve_kkt``,
     want_solver=False), timed;
  8. slice B: the D = 4096, M = 256 dense NLP through ``solve`` on cuda:0,
     with the 'condensed' and with the 'ldlt' linear solver, counters
     reset just before each timed solve;
  9. a D = 1000, M = 64 dense NLP on the card and on CPU tensors.
Each kernel is timed twice: ``ms``, CUDA events around one wrapper call
(what the path sees, host enqueue included), and ``device_ms``, the
kernel's own device time per launch from ``torch.profiler``, with the
launches per call it saw (or, where the profiler shows none, CUDA events
around 50 back-to-back calls; the record says which).  The line before the last is the kernels' JSON record, the
one before it the card's name and power limit; the last line is the JSON
result.  Needs one CUDA card and the repository checkout.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED, B, D, NLIN = 42, 10_000, 16, 4
N_CROSS = 64
KERNEL_SHAPES = ((10_000, 16), (10_000, 36), (129, 36), (1, 16), (512, 128))
# the solve kernel's lane layouts (half-warps to n = 16, then 1 to 4 entries
# per lane), at a batch that fills no CTA evenly; at the odd sizes from 69
# a CTA holds one or two instances, so most CTAs' factors start off a
# 16-byte boundary
SOLVE_SIZES = (1, 15, 17, 31, 32, 33, 64, 69, 95, 97, 100, 127, 128)
SOLVE_B = 1003
# the factor kernel's size buckets (half-warps to 16, a warp to 32, 48 and
# 64, a CTA per instance above) and their edges; B = 1003 to n = 36, 203
# above, so no CTA is filled evenly
FACTOR_SIZES = (1, 2, 15, 16, 17, 31, 32, 33, 36, 48, 49, 63, 64, 65, 69,
                95, 97, 127, 128)
FACTOR_REPEATS = 20
# a library call slower than this is timed again at LIBRARY_SMALL_B
LIBRARY_SLOW_S, LIBRARY_SMALL_B = 30.0, 1000
# |L D L^T x - b| <= RESIDUAL_C n eps (|L||D||L^T||x| + |b|), per entry
RESIDUAL_C = 2.0
# an f32 instance with a pivot below this is ill-conditioned: only there is
# the elementwise tolerance to the plain version widened (see check_solve)
PIVOT_FLOOR = 1e-2
PANEL_SIZES = (1, 2, 31, 33, 64, 100, 127, 128)
TIMED_SHAPES = ((10_000, 16), (10_000, 36))
FACTOR_ONLY_SHAPE = (512, 128)
REPS = 50                      # CUDA-event timings of a kernel call
# the dense NLP instance of phase 8, also solved by scripts/*dense_nlp*.py
DENSE_D, DENSE_M, DENSE_H = 4096, 256, 256
DENSE_SEED, DENSE_X0 = 0, 1e-3
CROSS_D, CROSS_M = 1000, 64
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
F64_FLOPS = 34e12              # H100 SXM float64 outside the tensor cores


def phase(name):
    print(f"== {name}", flush=True)


def rand_sym(gen, Bn, n, dtype, device):
    """Random symmetric matrices with diagonal shift n/4 (as the JAX
    package's kernel tests), every 7th made indefinite with a dominant
    diagonal of alternating sign so its pivots stay well away from 0."""
    A = torch.randn(Bn, n, n, generator=gen, dtype=torch.float64)
    A = (A + A.transpose(1, 2)) / 2
    sgn = torch.where(torch.arange(n) % 2 == 0, 1.0, -1.0).to(torch.float64)
    A_pd = A + torch.eye(n, dtype=torch.float64) * (n / 4)
    A_ind = 0.5 * A + torch.diag(sgn * n)
    pick = (torch.arange(Bn) % 7 == 3)[:, None, None]
    return torch.where(pick, A_ind, A_pd).to(dtype).to(device)


def cuda_ms(fn, reps):
    """Median of ``reps`` CUDA-event timings of one call, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def device_ms(fn, kernels, calls=REPS, traces=8):
    """(ms, method, launches): device time per launch of the CUDA kernels
    whose names contain one of ``kernels``, and their launches per call as
    the profiler saw them, from ``torch.profiler`` over ``calls``
    back-to-back calls of ``fn`` (each launches one such kernel).  The
    profiler now and then drops a kernel's events: a trace that shows fewer
    than ``calls`` launches is taken again, up to ``traces`` in all, and
    failing a whole one the fullest is used, its time divided by the
    launches it shows.  If none shows any, CUDA events around ``calls``
    calls, divided by ``calls`` (launches None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen, us = 0, 0.0
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        mine = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and any(k in e.key for k in kernels)]
        seen, us = max((seen, us),
                       (sum(e.count for e in mine),
                        sum(e.self_device_time_total for e in mine)))
        if seen >= calls:
            break
    if seen:
        return us / seen / 1e3, "torch.profiler", seen / calls
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(calls):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return (e0.elapsed_time(e1) / calls, f"CUDA events over {calls} calls",
            None)


def bound(nbytes, flops, peak_flops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / peak_flops * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def factor_bound(Bn, n):
    """bound() of B f32 LDL^T factors of n x n matrices: the lower triangle
    of A read (all the function depends on), the full L (unit diagonal and
    zeros above it included) and d written; 2n^3/3 operations each."""
    words = n * (n + 1) // 2 + n * n + n
    return bound(Bn * words * 4, Bn * 2 * n ** 3 / 3, F32_FLOPS)


def solve_bound(Bn, n):
    """bound() of B f32 solves L D L^T x = b: the strict lower triangle of
    the unit-lower L, d and b read, x written; 2n^2 operations each."""
    words = n * (n - 1) // 2 + 3 * n
    return bound(Bn * words * 4, Bn * 2 * n * n, F32_FLOPS)


def factor_timings(sl, A, plain_reps=10):
    """The small factor on A (B, n, n), f32: ms per call (CUDA events,
    median), the kernel's device ms per launch with the launches per call
    the profiler saw, the wrapper at B = 1 (its enqueue floor), the plain
    version's ms, and the bound."""
    return dict(
        factor=cuda_ms(lambda: sl.ldlt_factor_small(A), REPS),
        factor_device=device_ms(lambda: sl.ldlt_factor_small(A),
                                ("ldlt_factor_kernel",)),
        factor_floor=cuda_ms(lambda: sl.ldlt_factor_small(A[:1]), REPS),
        factor_plain=cuda_ms(lambda: sl.ldlt_factor_small_ref(A), plain_reps),
        factor_bound=factor_bound(A.shape[0], A.shape[-1]))


def reset(*counters):
    for counts in counters:
        for k in counts:
            counts[k] = 0


def same_bits(a, b):
    """Bitwise equal, NaN payloads aside: NaN at the same entries, every
    other entry with the same bits."""
    na, nb = torch.isnan(a), torch.isnan(b)
    it = torch.int32 if a.dtype == torch.float32 else torch.int64
    return (a.dtype == b.dtype and torch.equal(na, nb)
            and torch.equal(a.view(it)[~na], b.view(it)[~nb]))


def library_ms(fn, what):
    """(ms, warm-up s): one call timed with CUDA events after a warm-up
    call; ms is None if the call raises or the warm-up took more than
    LIBRARY_SLOW_S (then not timed again)."""
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        if warm > LIBRARY_SLOW_S:
            return None, warm
        return cuda_ms(fn, 1), warm
    except RuntimeError as exc:
        print(f"  {what} unavailable: {exc}", flush=True)
        return None, None


# ----------------------------------------------------------------------
def solve_backward_error(L, d, b, x):
    """Per instance, max_i |L D L^T x - b|_i / (n eps (|L||D||L^T||x| +
    |b|)_i), evaluated in float64 with eps of the working type: the
    componentwise backward error of substitution, in units of its bound."""
    n = L.shape[-1]
    eps = torch.finfo(L.dtype).eps
    Ld, dd, xd, bd = L.double(), d.double(), x.double(), b.double()
    M = (Ld * dd[:, None, :]) @ Ld.mT
    Ma = (Ld.abs() * dd.abs()[:, None, :]) @ Ld.abs().mT
    r = (torch.einsum("bij,bj->bi", M, xd) - bd).abs()
    s = torch.einsum("bij,bj->bi", Ma, xd.abs()) + bd.abs()
    return (r / (n * eps * s)).amax(dim=1)


def check_solve(sl, L, d, b, x, xr, what):
    """Hold a kernel solve x to its plain version xr.  The kernel subtracts
    its products one by one, the plain version sums a row first, so they
    differ by roundoff: the elementwise tolerance is f32 rtol 2e-3 / atol
    6e-3, f64 1e-10.  An f32 instance with a pivot below PIVOT_FLOOR
    amplifies that roundoff in both, so there, and only there, the
    tolerance is widened by twice the plain version's own distance from the
    float64 solve of the same factors.  And, leaning on neither, the
    backward error must be within RESIDUAL_C of its bound.  Returns that
    error's max and the number of instances widened."""
    f32 = L.dtype == torch.float32
    rtol, atol = (2e-3, 6e-3) if f32 else (1e-10,
                                           1e-10 * float(xr.abs().max()))
    own, widened = 0.0, 0
    if f32:
        ill = (d.abs().amin(dim=1) < PIVOT_FLOOR)[:, None]
        widened = int(ill.sum())
        x64 = sl.ldlt_solve_small_ref(L.double(), d.double(), b.double())
        own = (xr.double() - x64).abs().amax(dim=1, keepdim=True) * ill
    excess = float(((x - xr).abs().double()
                    - (atol + rtol * xr.abs().double() + 2 * own)).max())
    if not excess <= 0:
        raise AssertionError(f"{what}: solve differs from its plain version "
                             f"by {excess} more than the tolerance")
    c = float(solve_backward_error(L, d, b, x).max())
    if not c <= RESIDUAL_C:
        raise AssertionError(f"{what}: backward error {c} > {RESIDUAL_C} "
                             f"n eps (|L||D||L^T||x| + |b|)")
    return c, widened


def check_small_kernels(sl, device):
    """Phase 3; returns per-kernel error, timing and bound records."""
    gen = torch.Generator().manual_seed(SEED)
    err = {"factor": 0.0, "solve": 0.0}
    for dtype in (torch.float32, torch.float64):
        for Bn, n in KERNEL_SHAPES:
            A = rand_sym(gen, Bn, n, dtype, device)
            b = torch.randn(Bn, n, generator=gen,
                            dtype=torch.float64).to(dtype).to(device)
            L, d = sl.ldlt_factor_small(A)
            Lr, dr = sl.ldlt_factor_small_ref(A)
            x = sl.ldlt_solve_small(Lr, dr, b)
            xr = sl.ldlt_solve_small_ref(Lr, dr, b)
            torch.cuda.synchronize()
            if not (same_bits(L, Lr) and same_bits(d, dr)):
                raise AssertionError(f"factor differs from its plain version "
                                     f"at {(Bn, n)} {dtype}")
            # reconstruction, against the backward-error bound of unpivoted
            # LDL^T, which scales with |L||D||L^T| (= max|A| when no pivot
            # is small; a few of 10,000 random instances have one)
            Ld, dd = L.double(), d.double()
            rec = (Ld * dd[:, None, :]) @ Ld.transpose(1, 2)
            growth = (Ld.abs() * dd.abs()[:, None, :]) @ Ld.abs().transpose(1, 2)
            scale = torch.maximum(A.double().abs().amax(dim=(1, 2)),
                                  growth.amax(dim=(1, 2)))
            rec_tol = (5e-5 if dtype == torch.float32 else 1e-12) * n
            rec_err = ((rec - A.double()).abs().amax(dim=(1, 2)) / scale).max()
            if float(rec_err) > rec_tol:
                raise AssertionError(f"reconstruction error {float(rec_err)} "
                                     f"> {rec_tol} at {(Bn, n)} {dtype}")
            c, wide = check_solve(sl, Lr, dr, b, x, xr,
                                  f"{(Bn, n)} {dtype}")
            if dtype == torch.float32 and (Bn, n) in TIMED_SHAPES:
                err["factor"] = max(err["factor"],
                                    float((L - Lr).abs().max()),
                                    float((d - dr).abs().max()))
                err["solve"] = max(err["solve"], float((x - xr).abs().max()))
            print(f"  ok {str(dtype):14s} B={Bn:5d} n={n:3d}  "
                  f"max|d-dref|={float((d - dr).abs().max()):.3e}  "
                  f"max|x-xref|={float((x - xr).abs().max()):.3e}  "
                  f"backward error {c:.3f} of its bound, {wide} of {Bn} "
                  f"instances with a pivot under {PIVOT_FLOOR} held to the "
                  f"widened tolerance", flush=True)

        # the solve at every lane layout, with and without the row scale
        worst, wide = 0.0, 0
        for n in SOLVE_SIZES:
            A = rand_sym(gen, SOLVE_B, n, dtype, device)
            b, sc = (torch.randn(SOLVE_B, n, generator=gen,
                                 dtype=torch.float64).to(dtype).to(device)
                     for _ in range(2))
            sc = 0.25 + sc.abs()
            L, d = sl.ldlt_factor_small(A)
            for scale in (None, sc):
                x = sl.ldlt_solve_small(L, d, b, scale=scale)
                again = [sl.ldlt_solve_small(L, d, b, scale=scale)
                         for _ in range(20)]
                xr = sl.ldlt_solve_small_ref(L, d, b, scale)
                what = (f"n={n} {dtype} "
                        f"{'scaled' if scale is not None else 'plain'}")
                if not all(torch.equal(x, x2) for x2 in again):
                    raise AssertionError(f"{what}: not bitwise repeatable")
                if scale is None:
                    c, k = check_solve(sl, L, d, b, x, xr, what)
                else:
                    # the fused products are bitwise those taken outside
                    outside = sc * sl.ldlt_solve_small(L, d, sc * b)
                    if not torch.equal(x, outside):
                        raise AssertionError(f"{what}: differs from the "
                                             f"products taken outside")
                    c, k = check_solve(sl, L, d, sc * b, x / sc, xr / sc,
                                       what)
                worst, wide = max(worst, c), wide + k
        print(f"  ok ldlt_solve_small {str(dtype):14s} B={SOLVE_B} "
              f"n={SOLVE_SIZES}, with and without scale: bitwise repeatable "
              f"over 20 calls, backward error <= {worst:.3f} of its bound "
              f"(c = {RESIDUAL_C}), {wide} instances held to the widened "
              f"tolerance", flush=True)

    # the factor, bitwise, at every size bucket and its edges
    for dtype in (torch.float32, torch.float64):
        for n in FACTOR_SIZES:
            Bn = SOLVE_B if n <= 36 else 203
            A = rand_sym(gen, Bn, n, dtype, device)
            A[::2] -= (n / 2) * torch.eye(n, dtype=dtype, device=device)
            outs = [sl.ldlt_factor_small(A) for _ in range(FACTOR_REPEATS + 1)]
            Lr, dr = sl.ldlt_factor_small_ref(A)
            # a batch slice starts off a 16-byte boundary (odd n)
            Ls, ds = sl.ldlt_factor_small(A[1:])
            torch.cuda.synchronize()
            L, d = outs[0]
            what = f"ldlt_factor_small n={n} {dtype}"
            if not (same_bits(L, Lr) and same_bits(d, dr)):
                raise AssertionError(f"{what}: differs from its plain version"
                                     f", max|dd|={float((d - dr).abs().max())}")
            if not all(same_bits(L, L2) and same_bits(d, d2)
                       for L2, d2 in outs[1:]):
                raise AssertionError(f"{what}: not bitwise repeatable")
            if not (same_bits(Ls, Lr[1:]) and same_bits(ds, dr[1:])):
                raise AssertionError(f"{what}: the slice A[1:] differs")
        print(f"  ok ldlt_factor_small {str(dtype):14s} n={FACTOR_SIZES}, "
              f"B={SOLVE_B} (203 above 36), half indefinite: bitwise equal to "
              f"the plain version, over {FACTOR_REPEATS} more calls, and on "
              f"the slice A[1:]", flush=True)

    times = {}
    for Bn, n in TIMED_SHAPES:
        A = rand_sym(gen, Bn, n, torch.float32, device)
        b = torch.randn(Bn, n, generator=gen).to(device)
        L, d = sl.ldlt_factor_small(A)
        # library yardstick of the solve: LAPACK-style LDL^T solve with
        # identity pivots (timed here only, never called by the port); it
        # takes seconds per call, so one rep after a warm-up, and at
        # LIBRARY_SMALL_B instances if the warm-up exceeds LIBRARY_SLOW_S
        LD = torch.tril(L, -1) + torch.diag_embed(d)
        piv = torch.arange(1, n + 1, dtype=torch.int32,
                           device=device).expand(Bn, n).contiguous()
        lib_b = Bn
        lib_solve, warm = library_ms(lambda: torch.linalg.ldl_solve(
            LD, piv, b[..., None]), "torch.linalg.ldl_solve")
        if lib_solve is None and warm is not None:
            lib_b = LIBRARY_SMALL_B
            lib_solve, warm = library_ms(lambda: torch.linalg.ldl_solve(
                LD[:lib_b], piv[:lib_b], b[:lib_b, :, None]),
                "torch.linalg.ldl_solve")
        lib_note = (f"warm-up {warm:.1f} s" if warm is not None
                    else "unavailable")
        sc = 0.25 + torch.rand(Bn, n, generator=gen).to(device)
        solve_k = ("ldlt_solve_kernel",)
        times[n] = dict(
            factor_timings(sl, A),
            solve_device=device_ms(lambda: sl.ldlt_solve_small(L, d, b),
                                   solve_k),
            solve=cuda_ms(lambda: sl.ldlt_solve_small(L, d, b), REPS),
            # the wrapper's enqueue floor: the same call at B = 1
            solve_floor=cuda_ms(lambda: sl.ldlt_solve_small(
                L[:1], d[:1], b[:1]), REPS),
            # scaled: one launch, against the products taken outside
            solve_scaled=cuda_ms(lambda: sl.ldlt_solve_small(
                L, d, b, scale=sc), REPS),
            solve_scaled_device=device_ms(lambda: sl.ldlt_solve_small(
                L, d, b, scale=sc), solve_k),
            solve_scaled_outside=cuda_ms(lambda: sc * sl.ldlt_solve_small(
                L, d, (sc * b).contiguous()), REPS),
            solve_plain=cuda_ms(lambda: sl.ldlt_solve_small_ref(L, d, b), 10),
            solve_library=lib_solve,
            solve_library_b=lib_b,
            solve_bound=solve_bound(Bn, n))
        t = times[n]
        print(f"  f32 B={Bn} n={n}: factor {t['factor']:.4f} ms "
              f"(device {t['factor_device'][0]:.4f} ms per launch in "
              f"{t['factor_device'][2]} launches per call by "
              f"{t['factor_device'][1]}, the wrapper at B=1 "
              f"{t['factor_floor']:.4f} ms, plain {t['factor_plain']:.4f} ms, "
              f"bound {t['factor_bound'][0]:.5f} ms), solve "
              f"{t['solve']:.4f} ms (device {t['solve_device'][0]:.4f} ms in "
              f"{t['solve_device'][2]} launches per call, "
              f"the wrapper at B=1 {t['solve_floor']:.4f} ms, "
              f"plain {t['solve_plain']:.4f} ms, ldl_solve {lib_solve} ms at "
              f"B={lib_b} ({lib_note}), "
              f"bound {t['solve_bound'][0]:.5f} ms), scaled solve "
              f"{t['solve_scaled']:.4f} ms (device "
              f"{t['solve_scaled_device'][0]:.4f} ms; products outside "
              f"{t['solve_scaled_outside']:.4f} ms), CUDA events, median",
              flush=True)

    # the factor alone at the CTA scheme's largest size
    Bn, n = FACTOR_ONLY_SHAPE
    A = rand_sym(gen, Bn, n, torch.float32, device)
    times[n] = t = factor_timings(sl, A, plain_reps=3)
    print(f"  f32 B={Bn} n={n}: factor {t['factor']:.4f} ms (device "
          f"{t['factor_device'][0]:.4f} ms per launch in "
          f"{t['factor_device'][2]} launches per call by "
          f"{t['factor_device'][1]}, the "
          f"wrapper at B=1 {t['factor_floor']:.4f} ms, plain "
          f"{t['factor_plain']:.4f} ms, bound {t['factor_bound'][0]:.5f} ms "
          f"by {t['factor_bound'][1]}), CUDA events, median", flush=True)
    return err, times


# ----------------------------------------------------------------------
def kkt_matrix_bench(D_, M_, dtype, device, seed=0):
    """The single-shot KKT system of the JAX package's bench.py:60-66 from
    a numpy seed: [[G G'/D + 0.5 I, Je], [Je', 0]] and a random rhs."""
    rng = np.random.default_rng(seed)
    G = torch.as_tensor(rng.standard_normal((D_, D_)) / np.sqrt(D_),
                        device=device)
    Je = torch.as_tensor(rng.standard_normal((D_, M_)) / np.sqrt(D_),
                         device=device)
    g = torch.as_tensor(rng.standard_normal(D_ + M_), device=device)
    K = D_ + M_
    H = torch.zeros((K, K), dtype=torch.float64, device=device)
    H[:D_, :D_] = G @ G.T + 0.5 * torch.eye(D_, dtype=torch.float64,
                                             device=device)
    H[:D_, D_:] = Je
    H[D_:, :D_] = Je.T
    return H.to(dtype), g.to(dtype)


def exact_zero_pivot_panel(n, seed):
    """A panel with exact zero pivots whose factorization is exact in
    either type (small integers, pivots in {0, +-1, +-2}); at n < 5 the
    zero pivots wrap around."""
    rng = np.random.default_rng(seed)
    Lr = np.tril(rng.integers(-1, 2, (n, n)), -1) + np.eye(n)
    d = rng.choice([1.0, -1.0, 2.0, -2.0], n)
    d[np.array([1, n // 3, n - 5]) % n] = 0.0
    A = (Lr * np.where(d != 0, d, 1.0)) @ Lr.T
    A[d == 0, d == 0] -= 1.0
    return A


def rel_norm(x, xr):
    return float(torch.linalg.vector_norm((x - xr).double())
                 / torch.linalg.vector_norm(xr.double()))


def sweep_bound(K, w):
    """bound() of one f32 backward sweep of a K-row system at block width
    w.  The recurrence needs, of each block column that holds real rows,
    the slab below it down to row K (the grid padding past K is an
    identity tail) and the strict lower triangle of its diagonal block's
    unit-lower inverse; plus z and x.  Two operations per entry."""
    rows = [min(w, K - k0) for k0 in range(0, K, w)]
    slab = sum(r * (K - k0 - r) for k0, r in zip(range(0, K, w), rows))
    inv = sum(r * (r - 1) // 2 for r in rows)
    return bound((slab + inv + 2 * K) * 4, 2 * (slab + inv), F32_FLOPS)


def check_large_kernels(ll, lin, device):
    """Phase 6; returns per-kernel error, timing and bound records at the
    main path's shapes (f32, K = 4352)."""
    gen = torch.Generator().manual_seed(SEED)
    rec = {}
    for dtype in (torch.float32, torch.float64):
        for n in PANEL_SIZES:
            for kind in ("pd", "indef", "zero_pivot"):
                if kind == "zero_pivot":
                    A = torch.as_tensor(exact_zero_pivot_panel(n, n),
                                        dtype=dtype, device=device)
                else:
                    A = rand_sym(gen, 7, n, dtype, device)[
                        3 if kind == "indef" else 0].contiguous()
                L, d = ll.panel_ldlt(A)
                Lr, dr = ll.panel_ldlt_ref(A)
                torch.cuda.synchronize()
                if not (torch.equal(L, Lr) and torch.equal(d, dr)):
                    raise AssertionError(
                        f"panel_ldlt differs from its plain version: n={n} "
                        f"{dtype} {kind}, max|dd|="
                        f"{float((d - dr).abs().max())}")
        print(f"  ok panel_ldlt {str(dtype):14s} n={PANEL_SIZES} (pd, "
              f"indef, zero pivot): bitwise equal", flush=True)

    sweep_err = {"bwd_sweep_panels": 0.0, "bwd_sweep_blocks": 0.0}
    for dtype in (torch.float32, torch.float64):
        tol = 1e-5 if dtype == torch.float32 else 1e-10
        for Dk, Mk in ((4096, 256), (1772, 128)):
            H, g = kkt_matrix_bench(Dk, Mk, dtype, device)
            Hs, dsc = lin.ruiz_scale(H[None])
            Hs = Hs[0]
            Lp, dp, invp = lin.ldlt_factor_panels(Hs)
            Lb, db, invb = lin.ldlt_factor_blocks(Hs, group=8,
                                                  pad_to_grid=True)
            npad = Lp.shape[0]
            z = torch.randn(npad, generator=gen,
                            dtype=torch.float64).to(dtype).to(device)
            for name, fn, Lf, inv in (
                    ("bwd_sweep_panels", ll.bwd_sweep_panels, Lp, invp),
                    ("bwd_sweep_blocks", ll.bwd_sweep_blocks, Lb, invb)):
                x = fn(Lf, z, inv)
                xr = ll.bwd_sweep_ref(Lf, z, inv)
                again = [fn(Lf, z, inv) for _ in range(20)]
                torch.cuda.synchronize()
                e = rel_norm(x, xr)
                if not e <= tol:
                    raise AssertionError(f"{name} K={Dk + Mk} {dtype}: "
                                         f"relative error {e} > {tol}")
                if not all(torch.equal(x, x2) for x2 in again):
                    raise AssertionError(f"{name} is not deterministic")
                if dtype == torch.float32 and Dk == 4096:
                    sweep_err[name] = float((x - xr).abs().max())
                print(f"  ok {name} {str(dtype):14s} K={Dk + Mk} npad={npad}"
                      f" w={inv.shape[-1]}: |x-xref|/|xref|={e:.3e}",
                      flush=True)
            # a non-finite entry of z must reach x (the solver's NaN guard
            # depends on it), though the tiles of invb above its diagonal,
            # exact zeros, are skipped
            zb = z.clone()
            zb[Dk // 2] = float("nan")
            xb = ll.bwd_sweep_blocks(Lb, zb, invb)
            if bool(torch.isfinite(xb[Dk // 2])):
                raise AssertionError("bwd_sweep_blocks lost a NaN of z")
            del Lp, dp, invp, Lb, db, invb, H, Hs

    # timings at the main path's shapes: f32, K = 4352 (npad 5120)
    H, g = kkt_matrix_bench(4096, 256, torch.float32, device)
    Hs = lin.ruiz_scale(H[None])[0][0]
    Lp, dp, invp = lin.ldlt_factor_panels(Hs)
    Lb, db, invb = lin.ldlt_factor_blocks(Hs, group=8, pad_to_grid=True)
    npad = Lp.shape[0]
    z = torch.randn(npad, generator=gen).to(device)
    panel = Hs[:128, :128].contiguous()
    Lq, dq = ll.panel_ldlt(panel)
    rec["panel_ldlt"] = dict(
        max_abs_err=float(torch.maximum((Lq - ll.panel_ldlt_ref(panel)[0])
                                        .abs().max(),
                                        (dq - ll.panel_ldlt_ref(panel)[1])
                                        .abs().max())),
        ms=cuda_ms(lambda: ll.panel_ldlt(panel), 200),
        device_ms=device_ms(lambda: ll.panel_ldlt(panel),
                            ("panel_ldlt_kernel",)),
        plain_ms=cuda_ms(lambda: ll.panel_ldlt_ref(panel), 10),
        library_ms=None,
        bound=factor_bound(1, 128),
        shape=[128, 128])
    for name, fn, Lf, inv, kernels in (
            ("bwd_sweep_panels", ll.bwd_sweep_panels, Lp, invp,
             ("sweep_panels_kernel",)),
            ("bwd_sweep_blocks", ll.bwd_sweep_blocks, Lb, invb,
             ("sweep_blocks_kernel",))):
        Lt = Lf.mT
        # one launch per sweep, by the profiler's count: fail rather than
        # pass without it
        dev = device_ms(lambda: fn(Lf, z, inv), kernels)
        if dev[2] is None:
            raise AssertionError(f"{name}: the profiler showed none of its "
                                 f"launches in 8 traces")
        if not 0.5 < dev[2] < 1.5:
            raise AssertionError(f"{name}: {dev[2]} kernel launches per call "
                                 f"in the profile, expected 1")
        rec[name] = dict(
            max_abs_err=sweep_err[name],
            ms=cuda_ms(lambda: fn(Lf, z, inv), REPS),
            device_ms=dev,
            plain_ms=cuda_ms(lambda: ll.bwd_sweep_ref(Lf, z, inv), 20),
            library_ms=cuda_ms(lambda: torch.linalg.solve_triangular(
                Lt, z[:, None], upper=True, unitriangular=True), 20),
            bound=sweep_bound(Hs.shape[0], inv.shape[-1]),
            shape=[npad, inv.shape[-1]])
    for name, r in rec.items():
        print(f"  f32 {name} at {r['shape']}: {r['ms']:.4f} ms per call "
              f"(CUDA events, median), device {r['device_ms'][0]:.4f} ms "
              f"per launch in {r['device_ms'][2]} launches per call (by "
              f"{r['device_ms'][1]}), plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
              f"{r['bound'][0]:.5f} ms by {r['bound'][1]}", flush=True)
    return rec


def kkt_single_shot(lin, ll, cfg, device, reps=10):
    """Phase 7: median ms and GFLOP/s of one K = 4352 inertia-corrected
    factor+solve, and its relative residual."""
    Dk, Mk = 4096, 256
    K = Dk + Mk
    H, g = kkt_matrix_bench(Dk, Mk, torch.float32, device, seed=1)
    kw = dict(nvar=Dk, neq=Mk, nineq=0, eps=cfg.eps, reg_coef=cfg.reg_coef,
              eta=cfg.eta, beta=cfg.beta, delta0=cfg.delta0, max_retries=4,
              want_solver=False, block=cfg.ldlt_block)
    zero = torch.zeros(1, device=device)
    H1, g1 = H[None], g[None]
    run = lambda: lin.reg_solve_kkt(H1, g1, zero, zero + 0.1, **kw)  # noqa
    reset(ll.LAUNCHES)
    dz, delta_new, retries = run()
    torch.cuda.synchronize()
    launches = dict(ll.LAUNCHES)
    ms = cuda_ms(run, reps)
    r = H.double() @ dz[0].double() - g.double()
    res = float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(
        g.double()))
    bkw = float(torch.linalg.vector_norm(r) / (
        torch.linalg.matrix_norm(H.double())
        * torch.linalg.vector_norm(dz[0].double())
        + torch.linalg.vector_norm(g.double())))
    gflops = 2 * K ** 3 / 3 / (ms * 1e-3) / 1e9
    print(f"  K={K} f32 reg_solve_kkt(want_solver=False, max_retries=4): "
          f"{ms:.4f} ms median of {reps} (CUDA events), {gflops:.1f} GFLOP/s "
          f"at 2K^3/3, |H dz - g|/|g| {res:.3e}, backward error {bkw:.3e}, "
          f"delta_new {float(delta_new[0]):.3e}, retries {int(retries[0])}, "
          f"launches per call {launches}", flush=True)
    if not (np.isfinite(res) and bkw < 1e-5):
        raise AssertionError(f"K={K} solve: backward error {bkw}")
    return dict(ms=ms, gflops=gflops, residual=res, backward_error=bkw,
                launches=launches)


def dense_path(solve, cfg, problem, data, device, counters, _sync):
    """Phase 8 for one solver: warm-up from 0, timed solve from DENSE_X0."""
    Dd = problem.nvar
    solve(problem, torch.zeros(Dd, device=device), cfg, params=data)
    x0 = torch.full((Dd,), DENSE_X0, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset(_sync.COUNTS, *counters)
    t0 = time.perf_counter()
    res = solve(problem, x0, cfg, params=data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = dict(signal=int(res.signal), iters=int(res.iter_count),
               kkt_max=float(res.kkt.max()), fval=float(res.fval),
               wall_s=wall, host_syncs=_sync.COUNTS["host_syncs"],
               flat_steps=_sync.COUNTS["flat_steps"],
               reg_retries=int(res.reg_retries),
               launches={k: v for c in counters for k, v in c.items()},
               max_memory_bytes=torch.cuda.max_memory_allocated(device))
    if tuple(res.x.shape) != (Dd,) or not bool(torch.isfinite(res.x).all()):
        raise AssertionError("dense NLP solution is not a finite (D,) array")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        return 1
    from pyipm_tpu_torch import IPMConfig, _sync, solve, solve_batch
    from pyipm_tpu_torch.config import matmul_precision
    from pyipm_tpu_torch.models.random_nlp import (
        make_dense_nlp_problem, make_qp_problem, sample_dense_nlp,
        sample_qp_batch,
    )
    from pyipm_tpu_torch.ops import _build, large_ldlt as ll, linalg as lin
    from pyipm_tpu_torch.ops import small_ldlt as sl

    device = torch.device("cuda:0")

    phase("1 device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, count "
          f"{torch.cuda.device_count()}; {smi}", flush=True)

    phase("2 build")
    t0 = time.perf_counter()
    path, log = _build.build(force=True, verbose=True)
    _build.load()
    print(f"  built {path.name} from {len(_build.sources())} sources in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for line in log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  " + line.strip(), flush=True)

    phase("3 kernels 1-2 against their plain versions")
    err, times = check_small_kernels(sl, device)

    phase("4 slice A: 10,000-QP float32 fleet on cuda:0")
    cfg = IPMConfig(float_dtype="float32", verbosity=0, Ktol=1e-4)
    problem = make_qp_problem(D, NLIN)
    data = sample_qp_batch(SEED, B, D, NLIN, dtype="float32", device=device)
    solve_batch(problem, torch.zeros((B, D), device=device), cfg,
                params=data)                                     # warm-up
    rng = np.random.default_rng(7)
    x0 = torch.as_tensor(1e-6 * rng.standard_normal((B, D)),
                         dtype=torch.float32, device=device)
    torch.cuda.synchronize()
    reset(sl.LAUNCHES, ll.LAUNCHES, _sync.COUNTS)
    t0 = time.perf_counter()
    res = solve_batch(problem, x0, cfg, params=data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(sl.LAUNCHES)
    stats = dict(_sync.COUNTS)
    sig = res.signal.cpu().numpy()
    its = res.iter_count.cpu().numpy()
    hit = float(np.mean(np.isin(sig, (1, 2))))
    total = int(its.sum())
    syncs_per_step = stats["host_syncs"] / max(stats["flat_steps"], 1)
    print(f"  hit_rate={hit:.4f} mean_iters={its.mean():.3f} "
          f"max_iters={int(its.max())} total_iters={total} "
          f"wall_s={wall:.4f} iters_per_s={total / wall:.1f} "
          f"flat_steps={stats['flat_steps']} "
          f"host_syncs_per_step={syncs_per_step:.2f} "
          f"launches_factor={launches['factor']} "
          f"launches_solve={launches['solve']} (all kernel launches per "
          f"flat step: not measured here, scripts/profile_fleet.py counts "
          f"them)", flush=True)
    fleet = dict(hit_rate=hit, mean_iters=float(its.mean()),
                 max_iters=int(its.max()), wall_s=wall,
                 flat_steps=stats["flat_steps"],
                 host_syncs=stats["host_syncs"])
    if tuple(res.x.shape) != (B, D) or not bool(torch.isfinite(res.x).all()):
        raise AssertionError("fleet solution is not a finite (B, D) array")
    if hit < 0.99:
        raise AssertionError(f"hit rate {hit} < 0.99")
    conv = torch.as_tensor(np.isin(sig, (1,)), device=device)
    if not bool((res.kkt[conv] <= cfg.Ktol).all()):
        raise AssertionError("a Ktol-converged instance has KKT > Ktol")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel was not launched: {launches}")

    phase(f"5 plain path on CPU, first {N_CROSS} instances")
    data_cpu = type(data)(*(t[:N_CROSS].cpu() for t in data))
    res_cpu = solve_batch(problem, x0[:N_CROSS].cpu(), cfg, params=data_cpu)
    sg, sc = sig[:N_CROSS], res_cpu.signal.numpy()
    ig, ic = its[:N_CROSS], res_cpu.iter_count.numpy()
    xg, xc = res.x[:N_CROSS].cpu().numpy(), res_cpu.x.numpy()
    same_iters = int(np.sum(ig == ic))
    both = np.isin(sg, (1, 2)) & np.isin(sc, (1, 2))
    xerr = np.abs(xg - xc) / (1.0 + np.abs(xc))
    xerr_max = float(xerr[both].max()) if both.any() else 0.0
    print(f"  signals equal {int(np.sum(sg == sc))}/{N_CROSS}, iterations "
          f"equal {same_iters}/{N_CROSS}, max |dx|/(1+|x|) {xerr_max:.3e}",
          flush=True)
    if not np.array_equal(sg, sc):
        raise AssertionError("signals differ between kernel and plain path")
    if same_iters < 58:
        raise AssertionError(f"iteration counts equal on {same_iters} < 58")
    if xerr_max > 1e-3:
        raise AssertionError(f"x differs by {xerr_max} > 1e-3 (1+|x|)")
    del data, res, res_cpu

    # the solver turns TF32 off itself; the direct calls below do too
    with matmul_precision(cfg.matmul_precision):
        phase("6 kernels 3-5 against their plain versions")
        big = check_large_kernels(ll, lin, device)

        phase("7 single-shot K = 4352 KKT factor+solve")
        kkt = kkt_single_shot(lin, ll, cfg, device)

    phase(f"8 slice B: dense NLP D={DENSE_D}, M={DENSE_M}, float32, cuda:0")
    dproblem = make_dense_nlp_problem(DENSE_D, DENSE_M)
    ddata = sample_dense_nlp(DENSE_SEED, DENSE_D, DENSE_M, DENSE_H,
                             dtype="float32", device=device)
    dense = {}
    sweep_of = {"condensed": "bwd_sweep_blocks", "ldlt": "bwd_sweep_panels"}
    for solver in ("condensed", "ldlt"):
        dcfg = cfg.replace(linear_solver=solver)
        r = dense_path(solve, dcfg, dproblem, ddata, device,
                       (sl.LAUNCHES, ll.LAUNCHES), _sync)
        dense[solver] = r
        print(f"  {solver}: signal {r['signal']} iterations {r['iters']} "
              f"max KKT {r['kkt_max']:.3e} f {r['fval']:.6f} wall "
              f"{r['wall_s']:.4f} s host syncs {r['host_syncs']} flat steps "
              f"{r['flat_steps']} reg retries {r['reg_retries']} launches "
              f"{r['launches']} max_memory_allocated "
              f"{r['max_memory_bytes']} B", flush=True)
        if r["signal"] not in (1, 2):
            raise AssertionError(f"{solver}: signal {r['signal']}")
        if r["signal"] == 1 and r["kkt_max"] > cfg.Ktol:
            raise AssertionError(f"{solver}: Ktol-converged with KKT "
                                 f"{r['kkt_max']} > {cfg.Ktol}")
        for k in ("panel_ldlt", sweep_of[solver]):
            if r["launches"][k] == 0:
                raise AssertionError(f"{solver}: {k} was not launched")
    del ddata

    phase(f"9 dense NLP D={CROSS_D}, M={CROSS_M}: card against CPU")
    cproblem = make_dense_nlp_problem(CROSS_D, CROSS_M)
    cross = {}
    for dev in (device, torch.device("cpu")):
        cdata = sample_dense_nlp(1, CROSS_D, CROSS_M, DENSE_H,
                                 dtype="float32", device=dev)
        cross[dev.type] = solve(cproblem, torch.full((CROSS_D,), 1e-3,
                                                     device=dev),
                                cfg, params=cdata)
    cg, cc = cross["cuda"], cross["cpu"]
    xerr = float((torch.abs(cg.x.cpu() - cc.x) / (1 + torch.abs(cc.x))).max())
    print(f"  card: signal {int(cg.signal)} iterations {int(cg.iter_count)};"
          f" CPU: signal {int(cc.signal)} iterations {int(cc.iter_count)}; "
          f"max |dx|/(1+|x|) {xerr:.3e}", flush=True)
    if int(cg.signal) != int(cc.signal) or int(cg.signal) not in (1, 2):
        raise AssertionError("card and CPU signals differ or failed")
    if int(cg.iter_count) != int(cc.iter_count):
        raise AssertionError("card and CPU iteration counts differ")
    if xerr > 1e-3:
        raise AssertionError(f"x differs by {xerr} > 1e-3 (1+|x|)")

    def row(name, replaces, source, launches_, rec_, shape):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches_,
                "max_abs_err": rec_["max_abs_err"], "ms": rec_["ms"],
                "device_ms": rec_["device_ms"][0],
                "device_ms_by": rec_["device_ms"][1],
                "kernel_launches_per_call": rec_["device_ms"][2],
                "plain_ms": rec_["plain_ms"], "bound_ms": rec_["bound"][0],
                "bound_by": rec_["bound"][1],
                "library_ms": rec_["library_ms"], "shape": shape}

    t16 = times[16]
    small = "pyipm_tpu_torch/csrc/small_ldlt.cu"
    path_launches = {s: dense[s]["launches"] for s in dense}
    record = {"kernels": [
        row("ldlt_factor_small", "pyipm_tpu/ops/pallas_ldlt.py:49", small,
            launches["factor"],
            dict(max_abs_err=err["factor"], ms=t16["factor"],
                 device_ms=t16["factor_device"], plain_ms=t16["factor_plain"],
                 bound=t16["factor_bound"],
                 library_ms=None), [B, 16]),
        row("ldlt_solve_small", "pyipm_tpu/ops/pallas_ldlt.py:92", small,
            launches["solve"],
            dict(max_abs_err=err["solve"], ms=t16["solve"],
                 device_ms=t16["solve_device"], plain_ms=t16["solve_plain"],
                 bound=t16["solve_bound"],
                 library_ms=t16["solve_library"]), [B, 16]),
        row("panel_ldlt", "pyipm_tpu/ops/pallas_ldlt.py:198",
            "pyipm_tpu_torch/csrc/panel_ldlt.cu",
            sum(p["panel_ldlt"] for p in path_launches.values()),
            big["panel_ldlt"], big["panel_ldlt"]["shape"]),
        row("bwd_sweep_panels", "pyipm_tpu/ops/pallas_ldlt.py:523",
            "pyipm_tpu_torch/csrc/bwd_sweep_panels.cu",
            path_launches["ldlt"]["bwd_sweep_panels"],
            big["bwd_sweep_panels"], big["bwd_sweep_panels"]["shape"]),
        row("bwd_sweep_blocks", "pyipm_tpu/ops/pallas_ldlt.py:386",
            "pyipm_tpu_torch/csrc/bwd_sweep_blocks.cu",
            path_launches["condensed"]["bwd_sweep_blocks"],
            big["bwd_sweep_blocks"], big["bwd_sweep_blocks"]["shape"]),
    ], "launches_by_path": {"fleet": launches, **path_launches},
        "ldlt_factor_small_timings": {
            str(n): {"ms": t["factor"], "device_ms": t["factor_device"][0],
                     "kernel_launches_per_call": t["factor_device"][2],
                     "wrapper_floor_ms": t["factor_floor"],
                     "plain_ms": t["factor_plain"],
                     "bound_ms": t["factor_bound"][0]}
            for n, t in times.items()},
        "ldlt_solve_small_timings": {
            str(n): {"ms": t["solve"], "device_ms": t["solve_device"][0],
                     "kernel_launches_per_call": t["solve_device"][2],
                     "wrapper_floor_ms": t["solve_floor"],
                     "scaled_ms": t["solve_scaled"],
                     "scaled_device_ms": t["solve_scaled_device"][0],
                     "scaled_outside_ms": t["solve_scaled_outside"],
                     "library_ms": t["solve_library"],
                     "library_batch": t["solve_library_b"],
                     "bound_ms": t["solve_bound"][0]}
            for n, t in times.items() if "solve" in t},
        "fleet": fleet, "kkt_4352": kkt, "dense_nlp": dense}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
