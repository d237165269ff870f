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
     backward-error bound; both also at phase 16's sizes (n = 40, 65,
     67, 80, 96 and 97, B = 2,048); the factor bitwise on exact zero
     pivots, NaN and Inf at n = 65, 100 and 128; both timed at (10000,
     16) and (10000, 36), the factor also at (512, 128) and at phase
     16's sizes above 64 (its wide branch), the solve also at (2048, 97)
     (its wide kernel); the wide solve's instances resident an SM at
     n = 65, 80, 97 and 128;
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
  9. a D = 1000, M = 64 dense NLP on the card and on CPU tensors;
 10. the Mehrotra predictor-corrector on phase 4's fleet, the first 64
     instances also on CPU tensors;
 11. L-BFGS(8) on a D = 4096, M = 8 dense NLP in float64 through ``solve``;
 12. the ``IPM`` facade through the CLI's ``main`` on the ten reference
     problems (exact Hessian, L-BFGS, 'lu', float32), and
     ``python -m pyipm_tpu_torch`` once as a process;
 13. phase 4's fleet through ``make_wave_batch_solver`` (first wave 16,
     waves of 32; and waves of 4, which compact), held per instance to
     phase 4's lockstep result (the JAX package's wave contract; the
     bitwise-equal count printed);
 14. the same fleet paused by ``run_budget(3)``, saved with ``save_state``,
     restored onto the card and finished by ``run``: signals and iteration
     counts equal to phase 4's everywhere, x within 1e-5;
 15. the fleet at niter 2, miter 3 (every instance fails), and at niter
     3, miter 5 (about half converge), then ``rescue_failures``: hit rate
     >= 0.99 after, converged instances bit for bit;
 16. a mixed fleet through ``solve_fleet`` in float32: 2,048 portfolios of
     64 assets, SVM duals of 96 points, maximum-entropy problems of 64
     states and 2 moments, MPCs (nx 4, nu 2, horizon 20), 512 box QPs of
     D = 16, each bucket alone and then all with reference problem 5 in
     one call; per bucket the hit rate, iterations, wall, kernel 1-2
     launches by n and the structural checks of the JAX package's
     test_applications.py (a bucket under 0.99 is run again in float64),
     and a digest (sha256) of each bucket's signals, iterations and x;
     each bucket held instance by instance to the same ``solve_fleet``
     call on the CPU: signals equal (but on the instances of
     CLASSIFIED_SIGNAL_SPLITS), x within CARD_CPU_XTOL (1 + |x|) where
     both converged (STOP_APART_XTOL where the two stop at different
     iteration counts), iteration counts recorded;
 17. ``profile_solve`` of phase 13's wave fleet, ``trace()`` around a
     fleet solve with all six phase scopes in the trace, ``trace_metrics``
     on the fleet (unchanged to the bit, its history's bytes, instance 0's
     report), and ``python -m pyipm_tpu_torch 7 --profile DIR``;
 18. kernels 1-2 against their plain versions, as in phase 3, at every
     size n that a run of phases 4-17 launched them at and phase 3 did
     not check (phase 3 checks phase 16's sizes at its batch of 2,048);
 19. ``batched_reg_factor`` at (65536, 16), (16384, 17), (4096, 256) and
     (256, 1024) on blocks with wrong inertia (and eq blocks to
     regularize) against the same call on the plain versions (shifts,
     retries bitwise; backward error no worse); kernel 1 bitwise at
     (65536, 16) and (16384, 17), the batched kernel 3 at B = 1, 131,
     132, 133, 256, 264 and phase 26's 1,024, f32 and f64 (random,
     indefinite and exact-zero-pivot panels, either variant of
     ``panels_per_sm``); its two-panel variant resident two an SM; their
     timings (kernel 3 at B = 256 and 1,024);
 20. not run: the million-variable separable NLP (K = 4096, d = 256,
     mc = 8; the unrolled branch, no kernel) in float32 ends at signal -1,
     its stationarity norm stalled at the float32 error of its own
     evaluation (ROADMAP Queue 3; ``scripts/schur_f32_floor.py`` and
     ``scripts/profile_schur.py`` measure it);
 21. the block-separable Schur solver on a million variables as K =
     65,536 blocks of d = 16, mc = 4 without refinement, float32 (kernel 1
     at (65536, 16));
 22. K = 256 blocks of d = 1024, mc = 8, float32 (the batched kernel 3);
 23. resource allocation (16,384 agents x 16), cap 'ineq' under
     'adaptive' and 'mehrotra', cap 'eq' in float64; general block NLPs
     (K = 16,384, d = 3) with nonlinear and linear coupling; a ragged
     one; the capped one paused by ``run_budget(3)``, saved, restored and
     resumed; kernel 1 held to its plain version at the new sizes;
 24. two ranks on the card through ``launch --spawn 2`` on gloo (NCCL
     refuses two ranks on one card): phase 21's instance at K = 8,192
     against one process, and examples/distributed_fleet.py at 2 ranks
     against 1;
 25. the per-block L-BFGS mode at 524,288 variables, K = 8 blocks of d =
     65,536 (diagonal quadratics, bounds, linear coupling over mc = 4),
     L-BFGS(8), float32: signal 1 or 2, no kernel launched (none lies on
     this path), the peak allocation under 2 GiB; the same family at d =
     4,096 in float64 on the card and on the CPU (signal and iterations
     equal, x within 1e-8); examples/block_lbfgs_and_ragged.py;
     phases 21-25 draw their instances on the host with the port's numpy
     samplers (BLOCK_CELLS: one seed a cell) and hold every solve, the
     resumed one, both rank counts and phase 25's CPU side too, to the
     JAX package's answer to the same arrays (``hold_block_to_jax``
     against ``jax_reference/``, the arrays' sha256 first);
 26. 1,024 Markowitz portfolios of 500 assets (WIDE_PORTFOLIO) through
     ``solve_batch`` in float32: condensed systems of K = 501, the batched
     K > 128 path (kernel 3 at (1024, 128, 128), which must launch); hit
     rate (under 0.99 the fleet runs again in float64), iterations, the
     median wall of WIDE_TIMED solves, flat steps, host syncs, kernel-3
     launches by B, the busy share over 3 profiled iterations, the peak
     allocation, the structural checks and digests; one condensed
     direction of the first iterate as one batched ``reg_solve_kkt`` call
     and as 1,024 calls at B = 1 (wall, host syncs, launches each); rows
     0-15 solved one at a time at B = 1 on the card and as one batch on
     the CPU, each held as phase 16 holds a bucket (signals equal, x
     within CARD_CPU_XTOL['portfolio'], or STOP_APART_XTOL where the two
     stop at other iteration counts);
 27. the package's default float64 at full size, phase 26's tensors freed
     first: phase 4's and phase 10's fleets (``solve_batch``), phase 8's
     dense NLP with 'condensed' and 'ldlt' (``solve``), phase 16's
     buckets (``solve_fleet``) and phase 26's wide fleet (``solve_batch``,
     one timed solve), each drawn in float64 on the host (F64_CELLS), the
     counters reset just before it; per cell the wall, hit rate,
     iterations, host syncs, busy share, launches by kernel, n and B (the
     wide fleet's peak allocation too), the input sha256s beside the
     manifest's, and the hold to the JAX package's float64 answer (every
     signal and iteration count equal, x and f within JAX_F64_TOL);
     raises unless every kernel's float64 branch of this path launched
     inside a solve; then kernels 1-5 timed in float64 at these paths'
     shapes against their plain versions, library calls and bounds.
Phases 21-23, 25 and 26 each print the wall, iterations, flat steps, host
syncs, kernel launches by shape and the device's busy share over the
first 3 inner iterations of a second, profiled solve (21-25 also
all-reduces).
Each kernel is timed twice: ``ms``, CUDA events around one wrapper call
(what the path sees, host enqueue included), and ``device_ms``, the
kernel's own device time per launch from ``torch.profiler``, with the
launches per call it saw (or, where the profiler shows none, CUDA events
around 50 back-to-back calls; the record says which).  The line before the
last is the kernels' JSON record (with the launches of every path, and of
kernels 1-2 by n), the one before it the card's name and power limit, and
before that the total run time; the last line is the JSON result.  Needs
one CUDA card and the repository checkout.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED, B, D, NLIN = 42, 10_000, 16, 4
QP_X0_SEED = 7
N_CROSS = 64
KERNEL_SHAPES = ((10_000, 16), (10_000, 36), (129, 36), (1, 16), (512, 128))
# the sizes phase 16's buckets give kernels 1-2 (the condensed systems of
# MPC, portfolio, maximum entropy and SVM, n = 40, 65, 67 and 97; the SOC
# normal matrices of maximum entropy and MPC, k = 67 and 80; and n = 96),
# at the buckets' batch
PATH_B = 2048
PATH_SHAPES = tuple((PATH_B, n) for n in (40, 65, 67, 80, 96, 97))
# those of kernel 1's wide branch (64 < n <= 128), timed in phase 3; the
# kernels line's wide row is the SVM's n = 97
WIDE_SHAPES = tuple((Bn, n) for Bn, n in PATH_SHAPES if n > 64)
WIDE_ROW_SHAPE = (PATH_B, 97)
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
# the factor held bitwise on exact zero pivots, NaN and Inf at sizes of the
# wide branch (and one below it)
SPECIAL_SIZES = (65, 100, 128)
# a library call slower than this is timed again at LIBRARY_SMALL_B
LIBRARY_SLOW_S, LIBRARY_SMALL_B = 30.0, 1000
# |L D L^T x - b| <= RESIDUAL_C n eps (|L||D||L^T||x| + |b|), per entry
RESIDUAL_C = 2.0
# an f32 instance with a pivot below this is ill-conditioned: only there is
# the elementwise tolerance to the plain version widened (see check_solve)
PIVOT_FLOOR = 1e-2
PANEL_SIZES = (1, 2, 31, 33, 64, 100, 127, 128)
# batches of 128-panels held bitwise in phase 19 (f32 and f64): one panel,
# the edges of one and two panels an SM on the H100's 132 SMs, and phase
# 26's 1,024 (its fleet's first factorizations)
PANEL_BATCHES = (1, 131, 132, 133, 256, 264, 1024)
TIMED_SHAPES = ((10_000, 16), (10_000, 36))
FACTOR_ONLY_SHAPE = (512, 128)
REPS = 50                      # CUDA-event timings of a kernel call
# the dense NLP instance of phase 8, also solved by scripts/*dense_nlp*.py
DENSE_D, DENSE_M, DENSE_H = 4096, 256, 256
DENSE_SEED, DENSE_X0 = 0, 1e-3
CROSS_D, CROSS_M = 1000, 64
# the BENCH_r05 convergence figure of the JAX package's Mehrotra fleet on a
# TPU: a target for the iteration count only, never for a time
TPU_ERA_MEHROTRA_MEAN_ITERS = 4.38
# phase 11: the configuration of tests/test_lbfgs_large.py:26-37
LBFGS_D, LBFGS_M, LBFGS_MEM, LBFGS_SEED = 4096, 8, 8, 0
LBFGS_CFG = dict(float_dtype="float64", lbfgs=LBFGS_MEM, niter=10, miter=60)
# phase 12: the CLI runs, each with --seed 42
CLI_RUNS = ([[str(n)] for n in range(1, 11)]
            + [[str(n), "--lbfgs", "4"] for n in (1, 4, 5, 10)]
            + [[str(n), "--linear-solver", "lu"] for n in (3, 7, 8, 10)]
            + [["7", "--f32"]])
CLI_STOL = 1e-3
# phases 13-17: the wave budgets, the pause of phase 14, and the mixed
# fleet of phase 16 (portfolio and SVM of the JAX package's
# applications.py at 64 assets and 96 points of 8 features, maximum
# entropy over 64 states with 2 moments, MPC with nx = 4, nu = 2 over 20
# steps, box QPs of the heterogeneous-fleet example at D = 16)
WAVE_FIRST, WAVE, BUDGET = 16, 32, 3
# the fleet converges inside a first wave of 16: waves of 4 make it compact
WAVE_SMALL = 4
MIXED = dict(portfolio=2048, svm=2048, maxent=2048, mpc=2048, box=512)
PORTFOLIO_D, SVM_N, SVM_FEAT, MAXENT_D, MAXENT_M = 64, 96, 8, 64, 2
MPC_NX, MPC_NU, MPC_T, BOX_D = 4, 2, 20, 16
# phase 26: one rebalance per account of a book of 1,024 accounts over an
# S&P 500-sized universe, Markowitz portfolios of 500 assets (the family's
# factor-model covariance, cap 4/D), float32: condensed systems of K = 501,
# the batched K > 128 path (kernel 3 at (1024, 128, 128)); WIDE_TIMED
# timed solves, rows 0-15 held to the B = 1 card path and to the CPU path
WIDE_PORTFOLIO = dict(B=1024, D=500)
WIDE_TIMED, WIDE_ROWS = 3, 16
# the rows of phase 26's fleet held to the JAX package (jax_reference/)
WIDE_JAX_ROWS = 128
# phase 16 holds each bucket on the card to the same solve_fleet call on the
# CPU: x within this many (1 + |x|) where both converged.  The MPC bucket's
# float32 stationarity test is decided by roundoff on some instances (its
# |dL/dx| errs by up to ~40 Ktol in float32; ROADMAP Queue 3), so it gets
# more room: the JAX package and the port already differ by 3.1e-3 there.
CARD_CPU_XTOL = dict(portfolio=2e-3, svm=2e-3, maxent=2e-3, mpc=1e-2,
                     box_qp=2e-3)
# instances whose signal may differ between the card and the CPU, each
# classified as roundoff in ROADMAP Queue 3 (bucket -> indices): maximum
# entropy 1415 ends at signal -2 on the card only, where its equality
# residual comes out exactly 0 and the merit penalty's update divides by
# the tiny guard alone (nu ~ 1e31)
CLASSIFIED_SIGNAL_SPLITS = {"maxent": (1415,)}
# where the card and the CPU both converge but stop at different iteration
# counts (the float32 Ktol test passes at another iterate on each device), x
# is held to the float32 solution's own accuracy at Ktol instead: the float32
# and float64 solutions differ by a median of 3.5e-3 (1 + |x|) over the
# portfolio bucket on the CPU (ROADMAP Queue 3).  The MPC bucket's bound
# everywhere.
STOP_APART_XTOL = 1e-2
# the JAX package's answers to the numpy-seeded cells of phases 4, 8, 10,
# 11, 16 and 26, computed on the CPU by scripts/make_jax_reference.py and
# held by hold_to_jax: x as CARD_CPU_XTOL and STOP_APART_XTOL hold phase 16
# (a phase-16 bucket's own bound, 2e-3 in the other cells), f within
# JAX_FTOL (1 + |f|) where both converged, the mean iteration count within
# JAX_ITERS_RTOL of the reference's where it took the TPU dispatch
JAX_REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "jax_reference")
JAX_FTOL, JAX_ITERS_RTOL = 1e-3, 0.05
# instances whose signal may differ from the JAX package's, each classified
# in ROADMAP Queue 3 (cell -> indices; a Schur cell's one solve is index
# 0): maximum entropy 1415 ends at -2 on the card only (D1, as in
# CLASSIFIED_SIGNAL_SPLITS, pinned by a CPU test), the JAX package
# converges it on the CPU; the 256 x 1024 separable solve in float32 (D4)
# stops at signal 1 on the card where the JAX package's f32 stationarity
# norm stalls at 1.05 Ktol until -1, float32 evaluating it with an error
# of ~1.5 Ktol there
JAX_SIGNAL_SPLITS = {"mixed_maxent": (1415,), "schur_large": (0,)}
# a float64 cell, fleet or block (F64_CELLS, resource_eq_f64,
# lbfgs_block_f64): every signal and iteration count equal to the JAX
# package's, x (and the coupling multipliers) and f within this many
# (1 + |.|); no JAX_SIGNAL_SPLITS exception
JAX_F64_TOL = 1e-8
# float64 instances whose iteration count and result may differ from the
# JAX package's, each classified in ROADMAP Queue 3 (cell -> indices; held
# there as the float32 rule holds two solves that stop apart: signals
# equal, x within STOP_APART_XTOL, f within JAX_FTOL): the two QPs of the
# 'mehrotra' fleet (D5) whose merit penalty update divides a positive
# barrier slope by an l1 infeasibility of pure roundoff (~2e-15; the QPs
# have inequalities only), so nu (~1e12) and then the backtracking depth
# follow each side's rounding; the only two of the 10,000 whose nu leaves
# its initial 10
JAX_F64_SPLITS = {"qp_mehrotra_f64": (8248, 8760)}
# phase 27: the package's default float_dtype on the paths of phases 4,
# 10, 16, 26 and 8, each cell the float32 cell of the same name (its
# twin) with its instances drawn in float64 (``twin_arrays``)
F64_TWINS = ("qp_adaptive", "qp_mehrotra", "mixed_portfolio", "mixed_svm",
             "mixed_maxent", "mixed_mpc", "mixed_box_qp", "wide_portfolio",
             "dense_condensed", "dense_ldlt")
F64_CELLS = tuple(f"{c}_f64" for c in F64_TWINS)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
# H100 SXM float64 on the tensor cores (34e12 outside them): the higher of
# the card's two float64 rates, so a bound is the least time
F64_FLOPS = 67e12


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


def word_peak(dtype):
    """(bytes a word, peak operations a second) of ``dtype``."""
    return (8, F64_FLOPS) if dtype == torch.float64 else (4, F32_FLOPS)


def factor_bound(Bn, n, dtype=torch.float32):
    """bound() of B LDL^T factors of n x n matrices in ``dtype``: the lower
    triangle of A read (all the function depends on), the full L (unit
    diagonal and zeros above it included) and d written; 2n^3/3
    operations each."""
    words = n * (n + 1) // 2 + n * n + n
    size, peak = word_peak(dtype)
    return bound(Bn * words * size, Bn * 2 * n ** 3 / 3, peak)


def solve_bound(Bn, n, dtype=torch.float32):
    """bound() of B solves L D L^T x = b in ``dtype``: the strict lower
    triangle of the unit-lower L, d and b read, x written; 2n^2
    operations each."""
    words = n * (n - 1) // 2 + 3 * n
    size, peak = word_peak(dtype)
    return bound(Bn * words * size, Bn * 2 * n * n, peak)


def factor_timings(sl, A, plain_reps=10):
    """The small factor on A (B, n, n): ms per call (CUDA events,
    median), the kernel's device ms per launch with the launches per call
    the profiler saw, the wrapper at B = 1 (its enqueue floor), the plain
    version's ms, and the bound."""
    return dict(
        factor=cuda_ms(lambda: sl.ldlt_factor_small(A), REPS),
        factor_device=device_ms(lambda: sl.ldlt_factor_small(A),
                                ("ldlt_factor_kernel",)),
        factor_floor=cuda_ms(lambda: sl.ldlt_factor_small(A[:1]), REPS),
        factor_plain=cuda_ms(lambda: sl.ldlt_factor_small_ref(A), plain_reps),
        factor_bound=factor_bound(A.shape[0], A.shape[-1], A.dtype))


# (kernel, n) pairs of kernels 1-2: those phase 3 held against the plain
# version, and those the runs of phases 4-17 launched (folded in at each
# reset of LAUNCHES_BY_N); phase 18 holds the difference
HELD, SEEN = set(), set()


def reset(*counters):
    for counts in counters:
        SEEN.update(k for k, c in counts.items()
                    if c and isinstance(k, tuple)
                    and k[0] in ("factor", "solve"))
        for k in counts:
            counts[k] = 0


def same_bits(a, b):
    """Bitwise equal, NaN payloads aside: NaN at the same entries, every
    other entry with the same bits."""
    na, nb = torch.isnan(a), torch.isnan(b)
    it = torch.int32 if a.dtype == torch.float32 else torch.int64
    return (a.dtype == b.dtype and torch.equal(na, nb)
            and torch.equal(a.view(it)[~na], b.view(it)[~nb]))


def digests(signal, iters, x):
    """The first 16 hex digits of the sha256 of each tensor's bytes: two
    runs that print the same digests gave the same bits."""
    return {k: hashlib.sha256(t.detach().contiguous().cpu().numpy()
                              .tobytes()).hexdigest()[:16]
            for k, t in (("signal", signal), ("iters", iters), ("x", x))}


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


def hold_small(sl, gen, Bn, n, dtype, device):
    """Kernels 1-2 at (Bn, n) in ``dtype`` on random symmetric matrices
    (rand_sym): the factor bitwise equal to its plain version and within
    the backward-error bound of its reconstruction, the solve of the plain
    factors held to its plain version by check_solve.  Returns the
    factor's and the solve's max abs difference from the plain version."""
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
    c, wide = check_solve(sl, Lr, dr, b, x, xr, f"{(Bn, n)} {dtype}")
    HELD.update((("factor", n), ("solve", n)))
    e_factor = max(float((L - Lr).abs().max()), float((d - dr).abs().max()))
    e_solve = float((x - xr).abs().max())
    print(f"  ok {str(dtype):14s} B={Bn:5d} n={n:3d}  "
          f"max|d-dref|={float((d - dr).abs().max()):.3e}  "
          f"max|x-xref|={e_solve:.3e}  "
          f"backward error {c:.3f} of its bound, {wide} of {Bn} "
          f"instances with a pivot under {PIVOT_FLOOR} held to the "
          f"widened tolerance", flush=True)
    return e_factor, e_solve


def solve_timings(sl, gen, A, device):
    """Kernel 2 on the factors of A (B, n, n), f32, a random b and row
    scale: ms per call and device ms per launch, with and without the
    scale, the products taken outside, the wrapper at B = 1, the plain
    version, the library yardstick and the bound."""
    Bn, n, _ = A.shape
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
    sc = 0.25 + torch.rand(Bn, n, generator=gen).to(device)
    solve_k = ("ldlt_solve_kernel",)
    return dict(
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
        solve_library_note=(f"warm-up {warm:.1f} s" if warm is not None
                            else "unavailable"),
        solve_bound=solve_bound(Bn, n))


def print_solve_timings(Bn, n, t):
    print(f"  f32 B={Bn} n={n}: solve {t['solve']:.4f} ms (device "
          f"{t['solve_device'][0]:.4f} ms in {t['solve_device'][2]} "
          f"launches per call, the wrapper at B=1 {t['solve_floor']:.4f} "
          f"ms, plain {t['solve_plain']:.4f} ms, ldl_solve "
          f"{t['solve_library']} ms at B={t['solve_library_b']} "
          f"({t['solve_library_note']}), bound {t['solve_bound'][0]:.5f} "
          f"ms), scaled solve {t['solve_scaled']:.4f} ms (device "
          f"{t['solve_scaled_device'][0]:.4f} ms; products outside "
          f"{t['solve_scaled_outside']:.4f} ms), CUDA events, median",
          flush=True)


def check_small_kernels(sl, device):
    """Phase 3; returns per-kernel error, timing and bound records."""
    gen = torch.Generator().manual_seed(SEED)
    err = {"factor": 0.0, "solve": 0.0}
    for dtype in (torch.float32, torch.float64):
        for Bn, n in KERNEL_SHAPES + PATH_SHAPES:
            e_factor, e_solve = hold_small(sl, gen, Bn, n, dtype, device)
            if dtype == torch.float32 and (Bn, n) in TIMED_SHAPES:
                err["factor"] = max(err["factor"], e_factor)
                err["solve"] = max(err["solve"], e_solve)
            if dtype == torch.float32 and (Bn, n) == WIDE_ROW_SHAPE:
                err["factor_wide"] = e_factor
                err["solve_wide"] = e_solve

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
        HELD.update(("solve", n) for n in SOLVE_SIZES)
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
        HELD.update(("factor", n) for n in FACTOR_SIZES)
        print(f"  ok ldlt_factor_small {str(dtype):14s} n={FACTOR_SIZES}, "
              f"B={SOLVE_B} (203 above 36), half indefinite: bitwise equal to "
              f"the plain version, over {FACTOR_REPEATS} more calls, and on "
              f"the slice A[1:]", flush=True)
        hold_special_values(sl, gen, dtype, device)

    times = {}
    for Bn, n in TIMED_SHAPES:
        A = rand_sym(gen, Bn, n, torch.float32, device)
        times[n] = dict(factor_timings(sl, A),
                        **solve_timings(sl, gen, A, device))
        t = times[n]
        print(f"  f32 B={Bn} n={n}: factor {t['factor']:.4f} ms "
              f"(device {t['factor_device'][0]:.4f} ms per launch in "
              f"{t['factor_device'][2]} launches per call by "
              f"{t['factor_device'][1]}, the wrapper at B=1 "
              f"{t['factor_floor']:.4f} ms, plain {t['factor_plain']:.4f} ms, "
              f"bound {t['factor_bound'][0]:.5f} ms)", flush=True)
        print_solve_timings(Bn, n, t)

    # the factor alone at the wide branch's largest size and at phase 16's
    # sizes above 64
    for Bn, n in (FACTOR_ONLY_SHAPE,) + WIDE_SHAPES:
        A = rand_sym(gen, Bn, n, torch.float32, device)
        times[n] = t = factor_timings(sl, A, plain_reps=3)
        print(f"  f32 B={Bn} n={n}: factor {t['factor']:.4f} ms (device "
              f"{t['factor_device'][0]:.4f} ms per launch in "
              f"{t['factor_device'][2]} launches per call by "
              f"{t['factor_device'][1]}, the "
              f"wrapper at B=1 {t['factor_floor']:.4f} ms, plain "
              f"{t['factor_plain']:.4f} ms, bound {t['factor_bound'][0]:.5f} "
              f"ms by {t['factor_bound'][1]}), CUDA events, median",
              flush=True)
        if (Bn, n) == WIDE_ROW_SHAPE:
            # the solve's wide kernel, at the kernels line's wide row
            t.update(solve_timings(sl, gen, A, device))
            print_solve_timings(Bn, n, t)
    err["solve_residency"] = {}
    for n in (65, 80, 97, 128):
        warps, ctas = sl.solve_residency(n, torch.float32, device)
        err["solve_residency"][n] = warps * ctas
        print(f"  ldlt_solve_small at n={n}, f32: {warps} warps (instances) "
              f"a CTA, {ctas} CTAs resident an SM by the occupancy "
              f"calculator: {warps * ctas} instances an SM", flush=True)
    return err, times


def hold_special_values(sl, gen, dtype, device):
    """The factor bitwise equal to its plain version (NaN at the same
    entries) at SPECIAL_SIZES in ``dtype``: a panel with exact zero pivots
    (divided by 1), and batches of 6 with a NaN or an Inf below the
    diagonal of one instance and at the first pivot of another (a NaN
    pivot divides by 1 too), whose pivots must come out non-finite."""
    for n in SPECIAL_SIZES:
        cases = [("zero pivot", torch.as_tensor(
            exact_zero_pivot_panel(n, n)[None], dtype=dtype))]
        for v in (float("nan"), float("inf")):
            A = rand_sym(gen, 6, n, dtype, "cpu")
            A[2, n // 2, 1] = v                     # below the diagonal
            A[4, 0, 0] = v                          # the first pivot
            cases.append((str(v), A))
        for what, A in cases:
            A = A.to(device)
            L, d = sl.ldlt_factor_small(A)
            Lr, dr = sl.ldlt_factor_small_ref(A)
            torch.cuda.synchronize()
            if not (same_bits(L, Lr) and same_bits(d, dr)):
                raise AssertionError(f"ldlt_factor_small n={n} {dtype} "
                                     f"{what}: differs from its plain "
                                     f"version")
            if what != "zero pivot" and bool(torch.isfinite(d).all()):
                raise AssertionError(f"ldlt_factor_small n={n} {dtype} "
                                     f"{what}: the pivots stayed finite")
    print(f"  ok ldlt_factor_small {str(dtype):14s} n={SPECIAL_SIZES}: exact "
          f"zero pivots, NaN and Inf below the diagonal and at the first "
          f"pivot, bitwise equal to the plain version", flush=True)


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


def sweep_bound(K, w, dtype=torch.float32):
    """bound() of one backward sweep of a K-row system at block width w in
    ``dtype``.  The recurrence needs, of each block column that holds real
    rows, the slab below it down to row K (the grid padding past K is an
    identity tail) and the strict lower triangle of its diagonal block's
    unit-lower inverse; plus z and x.  Two operations per entry."""
    rows = [min(w, K - k0) for k0 in range(0, K, w)]
    slab = sum(r * (K - k0 - r) for k0, r in zip(range(0, K, w), rows))
    inv = sum(r * (r - 1) // 2 for r in rows)
    size, peak = word_peak(dtype)
    return bound((slab + inv + 2 * K) * size, 2 * (slab + inv), peak)


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
            Lb, db, invb = lin.ldlt_factor_blocks(Hs, group=8)
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
    Lb, db, invb = lin.ldlt_factor_blocks(Hs, group=8)
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
    """Phase 8 (phase 27 in float64) for one solver: warm-up from 0, timed
    solve from DENSE_X0, held to the cell of its solver and dtype; (record,
    result)."""
    Dd = problem.nvar
    solve(problem, torch.zeros(Dd, device=device), cfg, params=data)
    x0 = torch.full((Dd,), DENSE_X0, dtype=cfg.torch_dtype, device=device)
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
               launches={k: v for c in counters for k, v in c.items()
                         if isinstance(k, str)},
               max_memory_bytes=torch.cuda.max_memory_allocated(device))
    if tuple(res.x.shape) != (Dd,) or not bool(torch.isfinite(res.x).all()):
        raise AssertionError("dense NLP solution is not a finite (D,) array")
    cell = f"dense_{cfg.linear_solver}"
    if cfg.float_dtype == "float64":
        cell += "_f64"
    out["jax"] = hold_to_jax(cell, res.signal, res.iter_count, res.fval,
                             res.x)
    return out, res


def cross_check(sig, its, x, res_cpu, what, min_same_iters):
    """Hold the card's first N_CROSS instances to the CPU path's: equal
    signals, at least ``min_same_iters`` equal iteration counts, and x
    within 1e-3 (1 + |x|) where both converged."""
    sg, sc = sig[:N_CROSS], res_cpu.signal.numpy()
    ig, ic = its[:N_CROSS], res_cpu.iter_count.numpy()
    xg, xc = x[:N_CROSS], res_cpu.x.numpy()
    same_iters = int(np.sum(ig == ic))
    both = np.isin(sg, (1, 2)) & np.isin(sc, (1, 2))
    xerr = np.abs(xg - xc) / (1.0 + np.abs(xc))
    xerr_max = float(xerr[both].max()) if both.any() else 0.0
    print(f"  {what}: signals equal {int(np.sum(sg == sc))}/{N_CROSS}, "
          f"iterations equal {same_iters}/{N_CROSS}, max |dx|/(1+|x|) "
          f"{xerr_max:.3e}", flush=True)
    if not np.array_equal(sg, sc):
        raise AssertionError(f"{what}: signals differ between kernel and "
                             f"plain path")
    if same_iters < min_same_iters:
        raise AssertionError(f"{what}: iteration counts equal on "
                             f"{same_iters} < {min_same_iters}")
    if xerr_max > 1e-3:
        raise AssertionError(f"{what}: x differs by {xerr_max} > 1e-3 "
                             f"(1+|x|)")
    return dict(signals_equal=int(np.sum(sg == sc)), iters_equal=same_iters,
                max_rel_dx=xerr_max)


def require_launched(launches, what):
    if min(launches.values()) == 0:
        raise AssertionError(f"{what}: a kernel was not launched: "
                             f"{launches}")


def cli_runs():
    """Phase 12: every CLI_RUNS entry through ``cli.main`` in this process
    (on the card, the CLI's default), then ``python -m pyipm_tpu_torch``
    once as a process.  Each must report convergence to Ktol or Ftol and a
    distance to the nearest optimum within CLI_STOL."""
    from pyipm_tpu_torch import cli

    def check(args, out):
        conv = re.search(r"Converged to (Ktol|Ftol) tolerance", out)
        dist = re.search(r"Distance to nearest optimum: (\S+)", out)
        dist = float(dist.group(1)) if dist else float("nan")
        if not conv or not dist <= CLI_STOL:
            raise AssertionError(f"{' '.join(args)}: not converged within "
                                 f"{CLI_STOL}:\n{out}")
        print(f"  {' '.join(args):28s} {conv.group(0)}, distance to the "
              f"nearest optimum {dist:.3e}", flush=True)
        return dist

    worst = 0.0
    t0 = time.perf_counter()
    for args in CLI_RUNS:
        args = args + ["--seed", "42"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(args)
        worst = max(worst, check(args, buf.getvalue()))
    wall = time.perf_counter() - t0
    args = ["-m", "pyipm_tpu_torch", "7", "--seed", "42"]
    proc = subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode:
        raise AssertionError(f"python {' '.join(args)} exited "
                             f"{proc.returncode}:\n{proc.stderr}")
    check(["python"] + args, proc.stdout)
    return dict(runs=len(CLI_RUNS) + 1, worst_distance=worst, wall_s=wall)


# ----------------------------------------------------------------------
# phases 13-17: the fleet surfaces on phase 4's fleet and a mixed fleet
def by_n(sl):
    """Kernel 1-2 launches by system size n since the last reset."""
    out = {}
    for (k, n), c in sorted(sl.LAUNCHES_BY_N.items()):
        if c:
            out.setdefault(k, {})[str(n)] = c
    return out


def against_lockstep(ref, res, what):
    """Hold ``res`` to phase 4's lockstep result ``ref`` per instance:
    convergence sets, signals and iteration counts equal, max |dx|/(1+|x|)
    over the instances both converged, and the count bitwise equal (signal,
    iterations and every bit of x)."""
    sig, its = res.signal.cpu().numpy(), res.iter_count.cpu().numpy()
    x = res.x.cpu().numpy()
    conv, conv_r = np.isin(sig, (1, 2)), np.isin(ref["sig"], (1, 2))
    both = conv & conv_r
    dx = np.abs(x - ref["x"]) / (1 + np.abs(ref["x"]))
    out = dict(
        same_convergence=bool(np.array_equal(conv, conv_r)),
        signals_equal=int(np.sum(sig == ref["sig"])),
        iters_equal=int(np.sum(its == ref["its"])),
        max_rel_dx=float(dx[both].max()) if both.any() else 0.0,
        bitwise_equal=int(np.sum((sig == ref["sig"]) & (its == ref["its"])
                                 & np.all(x.view(np.int32)
                                          == ref["x"].view(np.int32),
                                          axis=1))),
        hit_rate=float(np.mean(conv)), mean_iters=float(its.mean()),
        max_iters=int(its.max()), total_iters=int(its.sum()))
    print(f"  {what} against the lockstep fleet: convergence sets equal "
          f"{out['same_convergence']}, signals equal {out['signals_equal']}/"
          f"{sig.size}, iterations equal {out['iters_equal']}/{sig.size}, "
          f"max |dx|/(1+|x|) {out['max_rel_dx']:.3e}, bitwise equal "
          f"{out['bitwise_equal']}/{sig.size}; hit rate "
          f"{out['hit_rate']:.4f}, mean {out['mean_iters']:.3f}, max "
          f"{out['max_iters']} iterations", flush=True)
    return out


def timed(fn, counters):
    """(result, wall s) of one call, the counters reset just before it."""
    torch.cuda.synchronize()
    reset(*counters)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_stats(wall, total_iters, sl, ll, _sync):
    return dict(wall_s=wall, iters_per_s=total_iters / wall,
                flat_steps=_sync.COUNTS["flat_steps"],
                host_syncs=_sync.COUNTS["host_syncs"],
                waves=_sync.COUNTS["waves"],
                launches={**sl.LAUNCHES, **ll.LAUNCHES},
                launches_by_n=by_n(sl))


def wave_phase(problem, cfg, x0, data, ref, counters, sl, ll, _sync,
               first_wave, wave):
    """Phase 13: the fleet through ``make_wave_batch_solver``."""
    from pyipm_tpu_torch import make_wave_batch_solver

    fn = make_wave_batch_solver(problem, cfg, first_wave=first_wave,
                                wave=wave)
    fn(torch.zeros_like(x0), data)                             # warm-up
    res, wall = timed(lambda: fn(x0, data), counters)
    what = f"wave ({first_wave}, {wave})"
    out = dict(against_lockstep(ref, res, what),
               **run_stats(wall, int(res.iter_count.sum()), sl, ll, _sync))
    print(f"  {what}: {out['waves']} waves, wall {wall:.4f} s, "
          f"{out['iters_per_s']:.1f} iters/s, flat steps "
          f"{out['flat_steps']}, host syncs {out['host_syncs']}, launches "
          f"{out['launches_by_n']}; lockstep (phase 4, this call): wall "
          f"{ref['wall_s']:.4f} s, flat steps {ref['flat_steps']}, host "
          f"syncs {ref['host_syncs']}, launches {ref['launches_by_n']}",
          flush=True)
    # the JAX package's own contract for a wave run (test_wave.py:70-86)
    if not out["same_convergence"]:
        raise AssertionError("wave: convergence set differs from lockstep")
    if out["iters_equal"] < 0.95 * B:
        raise AssertionError(f"wave: iteration counts equal on "
                             f"{out['iters_equal']} < 95%")
    if out["max_rel_dx"] > 2e-3 or out["hit_rate"] < 0.99:
        raise AssertionError(f"wave: max |dx|/(1+|x|) {out['max_rel_dx']}"
                             f", hit rate {out['hit_rate']}")
    require_launched(dict(sl.LAUNCHES), "wave fleet")
    return out, fn


def budget_phase(problem, cfg, x0, data, ref, counters, sl, ll, _sync):
    """Phase 14: run_budget(3), save, restore onto the card, run."""
    from pyipm_tpu_torch.core.solver import BatchSolver
    from pyipm_tpu_torch.utils.checkpoint import restore_state, save_state

    solver = BatchSolver(problem, cfg)
    # the restore template, built before any count is taken (its
    # init_state launches kernels 1-2 too)
    like = solver.init_state(torch.zeros_like(x0), data)
    st, t_budget = timed(lambda: solver.run_budget(
        solver.init_state(x0, data), BUDGET, data), counters)
    budget_launches = {**sl.LAUNCHES, **ll.LAUNCHES}
    budget_by_n = by_n(sl)
    paused = int((st.signal == 0).sum())
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fleet")
        t0 = time.perf_counter()
        save_state(path, st)
        t_save = time.perf_counter() - t0
        nbytes = os.path.getsize(path + ".npz")
        back, t_restore = timed(lambda: restore_state(path, like), ())
    if back.x.device != x0.device or not all(
            torch.equal(a, b) for a, b in zip(back, st)
            if a is not None):
        raise AssertionError("restored state differs from the saved one")
    res, t_run = timed(lambda: solver.finalize(solver.run(back, data),
                                               data), counters)
    resume_launches = {**sl.LAUNCHES, **ll.LAUNCHES}
    resume_by_n = by_n(sl)
    out = dict(against_lockstep(ref, res, "budget+checkpoint+resume"),
               paused=paused, checkpoint_bytes=nbytes, budget_s=t_budget,
               save_s=t_save, restore_s=t_restore, resume_s=t_run,
               launches={k: budget_launches[k] + resume_launches[k]
                         for k in budget_launches},
               launches_by_n=dict(budget=budget_by_n, resume=resume_by_n))
    print(f"  run_budget({BUDGET}) {t_budget:.4f} s left {paused} of {B} "
          f"paused, launches {budget_by_n}; checkpoint {nbytes} B, save "
          f"{t_save:.4f} s, restore onto {back.x.device} {t_restore:.4f} s;"
          f" resume {t_run:.4f} s, launches {resume_by_n}", flush=True)
    if out["signals_equal"] != B or out["iters_equal"] != B:
        raise AssertionError("resumed fleet: signals or iterations differ "
                             "from the lockstep fleet")
    if out["max_rel_dx"] > 1e-5:
        raise AssertionError(f"resumed fleet: max |dx|/(1+|x|) "
                             f"{out['max_rel_dx']} > 1e-5")
    require_launched({k: out["launches"][k] for k in sl.LAUNCHES},
                     "budget and resume")
    return out


def hold_seen_sizes(sl, device):
    """Phase 18: kernels 1-2 held to their plain versions, as phase 3
    does, at every size n a run launched them at and phase 3 did not
    check, at the batch PATH_B, f32 and f64.  Returns the sizes held."""
    gen = torch.Generator().manual_seed(SEED + 18)
    todo = sorted({n for _, n in SEEN - HELD})
    for dtype in (torch.float32, torch.float64):
        for n in todo:
            hold_small(sl, gen, PATH_B, n, dtype, device)
    if SEEN - HELD:
        raise AssertionError(f"sizes launched but not held: {SEEN - HELD}")
    return todo


def rescue_phase(problem, cfg, x0, data, counters, sl, ll, _sync, niter,
                 miter):
    """Phase 15: the fleet on a starved budget, then rescue_failures."""
    from pyipm_tpu_torch import rescue_failures, solve_batch

    rcfg = cfg.replace(niter=niter, miter=miter)
    res = solve_batch(problem, x0, rcfg, params=data)
    ok0 = (res.signal == 1) | (res.signal == 2)
    hit0 = float(ok0.float().mean())
    (merged, n_failed, n_rescued), wall = timed(
        lambda: rescue_failures(res, x0, rcfg, problem, data), counters)
    hit = float(((merged.signal == 1) | (merged.signal == 2)).float().mean())
    kept = all(same_bits(a[ok0], b[ok0]) if a.is_floating_point()
               else torch.equal(a[ok0], b[ok0])
               for a, b in zip(merged[:-1], res[:-1]))
    out = dict(hit_rate_before=hit0, n_failed=n_failed, n_rescued=n_rescued,
               hit_rate_after=hit, converged_untouched=kept, wall_s=wall,
               launches={**sl.LAUNCHES, **ll.LAUNCHES},
               launches_by_n=by_n(sl))
    print(f"  niter {niter}, miter {miter}: hit rate {hit0:.4f}; "
          f"rescue_failures: "
          f"n_failed {n_failed}, n_rescued {n_rescued}, hit rate after "
          f"{hit:.4f}, converged instances bit for bit {kept}, wall "
          f"{wall:.4f} s, launches {out['launches_by_n']}", flush=True)
    if hit < 0.99 or not kept:
        raise AssertionError(f"rescue: hit rate {hit}, converged instances "
                             f"untouched {kept}")
    require_launched(dict(sl.LAUNCHES), "rescue")
    return out


def qp_fleet(cfg, device):
    """Phase 4's fleet: (problem, data on the card, x0), after a warm-up
    solve from 0."""
    from pyipm_tpu_torch import solve_batch
    from pyipm_tpu_torch.models.random_nlp import (
        make_qp_problem, sample_qp_batch,
    )
    problem = make_qp_problem(D, NLIN)
    data = sample_qp_batch(SEED, B, D, NLIN, dtype="float32", device=device)
    solve_batch(problem, torch.zeros((B, D), device=device), cfg,
                params=data)                                     # warm-up
    x0 = torch.as_tensor(qp_x0(), device=device)
    torch.cuda.synchronize()
    return problem, data, x0


def qp_x0():
    """Phase 4's start: 1e-6 N(0, 1) from seed QP_X0_SEED, float32."""
    rng = np.random.default_rng(QP_X0_SEED)
    return (1e-6 * rng.standard_normal((B, D))).astype(np.float32)


def bucket_arrays(name, dtype=np.float32):
    """The numpy arrays of phase 16's bucket ``name`` in ``dtype``, drawn
    by the family's sampler (the box QPs by the heterogeneous-fleet
    example's ``box_qp_data``, stacked as W and c)."""
    from pyipm_tpu_torch.examples.heterogeneous_fleet import box_qp_data
    from pyipm_tpu_torch.models import applications as app

    n = MIXED
    if name == "box_qp":
        W, c = (np.stack(a).astype(dtype) for a in zip(*(
            box_qp_data(BOX_D, SEED + i) for i in range(n["box"]))))
        return dict(W=W, c=c)
    draw = dict(
        portfolio=lambda: app.sample_portfolio_arrays(
            SEED, n["portfolio"], PORTFOLIO_D, dtype),
        svm=lambda: app.sample_svm_arrays(SEED, n["svm"], SVM_N, SVM_FEAT,
                                          dtype),
        maxent=lambda: app.sample_maxent_arrays(SEED, n["maxent"], MAXENT_D,
                                                MAXENT_M, dtype),
        mpc=lambda: app.sample_mpc_arrays(SEED, n["mpc"], MPC_NX, MPC_NU,
                                          dtype))
    return draw[name]()


def mixed_buckets(device, dtype=np.float32):
    """Phase 16's buckets in ``dtype`` (phase 27's in float64): name ->
    (problem, data batched on the card, x0 (B, D))."""
    from pyipm_tpu_torch.examples.heterogeneous_fleet import box_qp_problem
    from pyipm_tpu_torch.models import applications as app

    n = MIXED
    pf = app.portfolio_data(bucket_arrays("portfolio", dtype), device=device)
    svm = app.svm_data(bucket_arrays("svm", dtype), device=device)
    me = app.maxent_data(bucket_arrays("maxent", dtype), device=device)
    mpc = app.mpc_data(bucket_arrays("mpc", dtype), device=device)
    box = tuple(torch.as_tensor(a, device=device)
                for a in bucket_arrays("box_qp", dtype).values())
    return {
        "portfolio": (app.make_portfolio_problem(PORTFOLIO_D), pf,
                      app.portfolio_x0(n["portfolio"], PORTFOLIO_D, dtype,
                                       device=device)),
        "svm": (app.make_svm_problem(SVM_N), svm, app.svm_x0(svm)),
        "maxent": (app.make_maxent_problem(MAXENT_D, MAXENT_M), me,
                   app.maxent_x0(n["maxent"], MAXENT_D, dtype,
                                 device=device)),
        "mpc": (app.make_mpc_problem(MPC_T, MPC_NU), mpc,
                app.mpc_x0(n["mpc"], MPC_T, MPC_NU, dtype, device=device)),
        "box_qp": (box_qp_problem(BOX_D), box,
                   torch.zeros((n["box"], BOX_D), dtype=box[0].dtype,
                               device=device)),
    }


@functools.lru_cache(maxsize=1)
def _wide_draw():
    from pyipm_tpu_torch.models import applications as app
    return app.sample_portfolio_arrays(SEED, WIDE_PORTFOLIO["B"],
                                       WIDE_PORTFOLIO["D"], np.float64)


def wide_arrays(dtype=np.float32):
    """Phase 26's portfolios (phase 27's in float64): the sampler's float64
    draw, cast (its own cast, so the same bits as drawing in ``dtype``),
    kept from phase 26 to phase 27 (~20 s of host time a draw)."""
    return {k: v.astype(dtype) for k, v in _wide_draw().items()}


def twin_arrays(cell):
    """The numpy instances of a cell of F64_TWINS or F64_CELLS as its phase
    draws them on the host: the twin's sampler and seed, in float32, or in
    float64 for an ``_f64`` cell."""
    from pyipm_tpu_torch.models.random_nlp import (
        sample_dense_arrays, sample_qp_arrays,
    )
    base = cell.removesuffix("_f64")
    if base not in F64_TWINS:
        raise ValueError(f"{cell}: not a cell of F64_TWINS or F64_CELLS")
    dtype = np.dtype(np.float64 if base != cell else np.float32)
    if base.startswith("qp_"):
        return sample_qp_arrays(SEED, B, D, NLIN, dtype)
    if base.startswith("dense_"):
        return sample_dense_arrays(DENSE_SEED, DENSE_D, DENSE_M, DENSE_H,
                                   dtype)
    if base == "wide_portfolio":
        return wide_arrays(dtype)
    return bucket_arrays(base.removeprefix("mixed_"), dtype)


def structure_ok(name, x, data, fval, prob):
    """The structural checks of the JAX package's test_applications.py
    (:20-97) on the converged instances; returns the worst violation
    (<= 0 passes)."""
    tol = 2e-3
    if name in ("portfolio", "maxent"):
        worst = max(float((x.sum(-1) - 1).abs().max()) - tol,
                    float(-x.min()) - (tol if name == "portfolio" else 1e-4))
        if name == "portfolio":
            worst = max(worst, float((x - data.cap).max()) - tol)
        else:
            mom = torch.einsum("bmd,bd->bm", data.A, x)
            worst = max(worst, float((mom - data.b).abs().max()) - 5e-3)
        return worst
    if name == "svm":
        return max(float((data.y * x).sum(-1).abs().max()) - tol,
                   float(-x.min()) - tol,
                   float((x - data.C[:, None]).max()) - tol)
    if name == "mpc":
        f0 = prob.f_val(torch.zeros_like(x), data)
        return max(float((x.abs() - data.umax[:, None]).max()) - tol,
                   float((fval - f0).max()) - 1e-5)
    return float(x.abs().max()) - 1.0 - tol                   # box QPs


def card_against_cpu(name, res, ref, cpu_wall, against="CPU"):
    """Hold a bucket's card results to the CPU path's (or to ``against``'s,
    results on the CPU), instance by instance: signals equal except on
    CLASSIFIED_SIGNAL_SPLITS, x within CARD_CPU_XTOL (1 + |x|) where both
    converged, or within STOP_APART_XTOL where they converged at different
    iteration counts; iteration counts and objective values are recorded,
    not held."""
    sg, sc = res.signal.cpu().numpy(), ref.signal.numpy()
    ig, ic = res.iter_count.cpu().numpy(), ref.iter_count.numpy()
    both = np.isin(sg, (1, 2)) & np.isin(sc, (1, 2))
    xg, xc = res.x.cpu().numpy(), ref.x.numpy()
    fg, fc = res.fval.cpu().numpy(), ref.fval.numpy()
    dx = (np.abs(xg - xc) / (1.0 + np.abs(xc))).max(-1)
    df = np.abs(fg - fc) / (1.0 + np.abs(fc))
    apart = both & (ig != ic)
    tol = np.where(apart, max(CARD_CPU_XTOL[name], STOP_APART_XTOL),
                   CARD_CPU_XTOL[name])
    sig_diff = np.flatnonzero(sg != sc).tolist()
    its_diff = np.flatnonzero(ig != ic).tolist()
    beyond = np.flatnonzero(both & (dx > tol)).tolist()
    wide = np.flatnonzero(apart & (dx > CARD_CPU_XTOL[name])).tolist()
    out = dict(signals_equal=int(np.sum(sg == sc)), signals_differ=sig_diff,
               iters_equal=int(np.sum(ig == ic)), iters_differ=its_diff[:20],
               max_rel_dx=float(dx[both].max()) if both.any() else 0.0,
               max_rel_df=float(df[both].max()) if both.any() else 0.0,
               stop_apart=int(apart.sum()),
               stop_apart_beyond_xtol={i: (float(dx[i]), int(ig[i]),
                                           int(ic[i])) for i in wide},
               x_beyond={i: float(dx[i]) for i in beyond},
               cpu_signals={str(k): int(v) for k, v in
                            zip(*np.unique(sc, return_counts=True))},
               cpu_mean_iters=float(ic.mean()), cpu_max_iters=int(ic.max()),
               cpu_wall_s=cpu_wall)
    print(f"  {name} card against {against}: signals equal "
          f"{out['signals_equal']}/"
          f"{sg.size}, differ at {sig_diff}; iterations equal "
          f"{out['iters_equal']}/{sg.size}, differ first at {its_diff[:20]};"
          f" max |dx|/(1+|x|) {out['max_rel_dx']:.3e}, max |df|/(1+|f|) "
          f"{out['max_rel_df']:.3e} where both converged; "
          f"{out['stop_apart']} converged at different iteration counts, "
          f"beyond {CARD_CPU_XTOL[name]} (held within {STOP_APART_XTOL}) at "
          f"{{index: (dx, card, CPU iterations)}} "
          f"{out['stop_apart_beyond_xtol']}; x beyond its bound at "
          f"{out['x_beyond']}; {against} signals {out['cpu_signals']}, mean "
          f"{out['cpu_mean_iters']:.6f}, max {out['cpu_max_iters']} "
          f"iterations, {cpu_wall:.1f} s", flush=True)
    unclassified = sorted(set(sig_diff)
                          - set(CLASSIFIED_SIGNAL_SPLITS.get(name, ())))
    if unclassified:
        raise AssertionError(f"{name}: card and {against} signals differ at "
                             f"{unclassified}, classified nowhere (ROADMAP "
                             f"Queue 3)")
    if beyond:
        raise AssertionError(f"{name}: card and {against} x differ beyond "
                             f"{CARD_CPU_XTOL[name]} (1+|x|), or "
                             f"{STOP_APART_XTOL} at other iteration counts, "
                             f"at {out['x_beyond']}")
    return out


def jax_reference(cell):
    """(manifest entry, arrays) of ``cell``'s file in JAX_REFERENCE, its
    bytes checked against the manifest's sha256: a missing or stale file
    raises."""
    with open(os.path.join(JAX_REFERENCE, "MANIFEST.json")) as fh:
        entry = json.load(fh)["cells"].get(cell)
    if entry is None:
        raise AssertionError(f"{cell}: not in jax_reference/MANIFEST.json "
                             f"(scripts/make_jax_reference.py --cell {cell})")
    with open(os.path.join(JAX_REFERENCE, entry["file"]), "rb") as fh:
        blob = fh.read()
    if hashlib.sha256(blob).hexdigest() != entry["sha256"]:
        raise AssertionError(f"{cell}: jax_reference/{entry['file']} does "
                             f"not match its sha256 in the manifest")
    with np.load(io.BytesIO(blob)) as z:
        return entry, {k: z[k] for k in z.files}


def hold_to_jax(cell, signal, iters, f, x, rows=None):
    """Hold a cell's results to the JAX package's (``jax_reference``),
    instance by instance: signals equal except on JAX_SIGNAL_SPLITS; where
    both converged, f within JAX_FTOL (1 + |f|) and, on the rows whose x
    the reference keeps, x within the cell's CARD_CPU_XTOL (1 + |x|) at
    equal iteration counts and STOP_APART_XTOL at different ones; the mean
    iteration count within JAX_ITERS_RTOL of the reference's where it took
    the TPU dispatch (recorded only where it took the CPU path).  A
    float64 cell is held strictly: every signal equal (no
    JAX_SIGNAL_SPLITS exception), every iteration count equal, f within
    JAX_F64_TOL (1 + |f|) on every instance and x on every kept row, but
    on the instances of JAX_F64_SPLITS, whose counts may differ and whose
    x and f are held within STOP_APART_XTOL and JAX_FTOL.  ``rows``: the
    reference's instances the results stand for (all by default)."""
    t0 = time.perf_counter()
    entry, ref = jax_reference(cell)
    f64 = entry["dtype"] == "float64"

    def host(t):
        return np.asarray(t.detach().cpu() if torch.is_tensor(t) else t)

    sg, ig, fg = (host(t).reshape(-1) for t in (signal, iters, f))
    xg = host(x).reshape(sg.size, -1).astype(np.float64)
    rows = np.arange(entry["instances"]) if rows is None else np.asarray(rows)
    if rows.size != sg.size:
        raise AssertionError(f"{cell}: {sg.size} results for {rows.size} "
                             f"reference rows")
    sr, ir = ref["signal"][rows], ref["iter_count"][rows].astype(np.int64)
    fr = ref["f"][rows]
    both = np.isin(sg, (1, 2)) & np.isin(sr, (1, 2))
    df = np.abs(fg - fr) / (1.0 + np.abs(fr))
    at = {int(r): i for i, r in enumerate(rows)}
    pairs = [(at[int(r)], k) for k, r in enumerate(ref["x_rows"])
             if int(r) in at]
    gi = np.array([g for g, _ in pairs], dtype=np.int64)
    xr = ref["x"][[k for _, k in pairs]].astype(np.float64)
    dx = (np.abs(xg[gi] - xr) / (1.0 + np.abs(xr))).max(-1, initial=0.0)
    if f64:
        # a classified instance is held as the float32 rule holds two
        # solves that stop apart
        apart = np.isin(rows, JAX_F64_SPLITS.get(cell, ()))
        xtol = ftol = JAX_F64_TOL
        tol = np.where(apart[gi], STOP_APART_XTOL, xtol)
        ftols = np.where(apart, JAX_FTOL, ftol)
        held, fheld = np.ones(gi.size, bool), np.ones(sg.size, bool)
    else:
        apart = np.zeros(sg.size, bool)
        xtol, ftol = CARD_CPU_XTOL.get(cell.removeprefix("mixed_"),
                                       2e-3), JAX_FTOL
        tol = np.where(ig[gi] == ir[gi], xtol, max(xtol, STOP_APART_XTOL))
        ftols = np.full(sg.size, ftol)
        held, fheld = both[gi], both
    x_beyond = {int(rows[g]): float(d)
                for g, d, t, h in zip(gi, dx, tol, held) if h and d > t}
    wide = {int(rows[g]): (float(d), int(ig[g]), int(ir[g]))
            for g, d, h in zip(gi, dx, held) if h and xtol < d}
    f_beyond = {int(rows[i]): float(df[i])
                for i in np.flatnonzero(fheld & (df > ftols))}
    split = rows[sg != sr].tolist()
    its_diff = rows[ig != ir].tolist()
    its_unclassified = rows[(ig != ir) & ~apart].tolist()
    classified = {int(rows[i]): (float(df[i]), int(ig[i]), int(ir[i]))
                  for i in np.flatnonzero(apart)}
    mean_g, mean_r = float(ig.mean()), float(ir.mean())
    kernel = entry["jax_path"] != "cpu"
    out = dict(jax_path=entry["jax_path"], dtype=entry["dtype"],
               signals_equal=int(np.sum(sg == sr)), signals_differ=split,
               iters_equal=int(np.sum(ig == ir)), iters_differ=its_diff[:20],
               x_rows_held=int(held.sum()),
               max_rel_dx=float(dx[held].max()) if held.any() else 0.0,
               max_rel_df=float(df[fheld].max()) if fheld.any() else 0.0,
               stop_apart_beyond_xtol=wide, classified=classified,
               mean_iters=mean_g,
               jax_mean_iters=mean_r, hold_s=time.perf_counter() - t0)
    rule = (f"float64: held within {xtol}, f {ftol}, iterations held; "
            f"JAX_F64_SPLITS at {{index: (df, here, JAX iterations)}} "
            f"{classified}" if f64
            else f"beyond {xtol} (held within {STOP_APART_XTOL} at other "
            f"counts) at {{index: (dx, here, JAX iterations)}} {wide}")
    print(f"  {cell} against the JAX package ({entry['jax_path']}): "
          f"signals equal {out['signals_equal']}/{sg.size}, differ at "
          f"{split}; iterations equal {out['iters_equal']}/{sg.size}, "
          f"differ first at {its_diff[:20]}; max |dx|/(1+|x|) "
          f"{out['max_rel_dx']:.3e} over {out['x_rows_held']} rows, max "
          f"|df|/(1+|f|) {out['max_rel_df']:.3e} "
          f"{'over every instance' if f64 else 'where both converged'}; "
          f"{rule}; mean iterations {mean_g:.4f} here, {mean_r:.4f} JAX "
          f"({'held' if kernel or f64 else 'recorded'}); "
          f"{out['hold_s']:.3f} s", flush=True)
    unclassified = sorted(set(split) - set(
        () if f64 else JAX_SIGNAL_SPLITS.get(cell, ())))
    if unclassified:
        raise AssertionError(f"{cell}: signals differ from the JAX package's"
                             f" at {unclassified}, classified nowhere "
                             f"(ROADMAP Queue 3)")
    if its_unclassified and f64:
        raise AssertionError(f"{cell}: iteration counts differ from the JAX "
                             f"package's in float64 at "
                             f"{its_unclassified[:20]}, classified nowhere "
                             f"(ROADMAP Queue 3)")
    if x_beyond or f_beyond:
        raise AssertionError(f"{cell}: x beyond {xtol} (1+|x|) (or "
                             f"{STOP_APART_XTOL} at other iteration counts) "
                             f"at {x_beyond}; f beyond {ftol} (1+|f|) at "
                             f"{f_beyond}")
    if kernel and abs(mean_g - mean_r) > JAX_ITERS_RTOL * mean_r:
        raise AssertionError(f"{cell}: mean iterations {mean_g} against the "
                             f"JAX package's {mean_r}, beyond "
                             f"{JAX_ITERS_RTOL:.0%}")
    return out


def retype(data, leaves):
    """``leaves`` in ``data``'s container (a NamedTuple or a tuple)."""
    leaves = tuple(leaves)
    return type(data)(*leaves) if hasattr(data, "_fields") else leaves


def stack(results):
    """One result of batched tensors from a list of per-instance results."""
    return type(results[0])(*(
        type(f)(*(torch.stack(c) for c in zip(*g)))
        if isinstance(f, tuple) else torch.stack(g)
        for f, g in zip(results[0], zip(*results))))


def solve_bucket(prob, data, x0b, cfg, device):
    """A whole bucket through ``solve_fleet``, phase 16's call, on
    ``device`` (the data and x0 moved there), stacked."""
    from pyipm_tpu_torch import solve_fleet
    from pyipm_tpu_torch.core.linesearch import take
    data = retype(data, (t.to(device) for t in data))
    Bn = x0b.shape[0]
    return stack(solve_fleet([prob] * Bn, list(x0b.to(device)), cfg,
                             params=[take(data, i) for i in range(Bn)],
                             device=device))


def mixed_fleet_phase(cfg, device, counters, sl, ll, _sync):
    """Phase 16: each bucket alone through solve_fleet, then all of them
    and reference problem 5 in one mixed solve_fleet call."""
    from pyipm_tpu_torch import solve_fleet
    from pyipm_tpu_torch.core.linesearch import take
    from pyipm_tpu_torch.models.reference_problems import get_problem

    def rows(data, idx):
        return [take(data, i) for i in idx]

    buckets = mixed_buckets(device)
    out, alone = {}, {}
    for name, (prob, data, x0b) in buckets.items():
        Bn = x0b.shape[0]
        params = rows(data, range(Bn))
        args = ([prob] * Bn, list(x0b), cfg)
        solve_fleet(args[0][:64], args[1][:64], cfg, params=params[:64],
                    device=device)                             # warm-up
        results, wall = timed(lambda: solve_fleet(*args, params=params,
                                                  device=device), counters)
        res = stack(results)
        alone[name] = res
        dig = digests(res.signal, res.iter_count, res.x)
        print(f"  {name} digests (sha256 of the bytes): {dig}", flush=True)
        sig, its = res.signal.cpu().numpy(), res.iter_count.cpu().numpy()
        conv = torch.as_tensor(np.isin(sig, (1, 2)), device=device)
        hit = float(conv.float().mean())
        worst = structure_ok(name, res.x[conv], take(data, conv),
                             res.fval[conv], prob)
        rec = dict(instances=Bn, nvar=prob.nvar, neq=prob.neq,
                   nineq=prob.nineq, hit_rate=hit,
                   mean_iters=float(its.mean()), max_iters=int(its.max()),
                   signals={str(k): int(v) for k, v in
                            zip(*np.unique(sig, return_counts=True))},
                   structure_worst=worst, digests=dig,
                   **run_stats(wall, int(its.sum()), sl, ll, _sync))
        print(f"  {name} B={Bn} (D={prob.nvar}, M={prob.neq}, "
              f"N={prob.nineq}): hit rate {hit:.4f}, mean "
              f"{rec['mean_iters']:.3f}, max {rec['max_iters']} iterations,"
              f" signals {rec['signals']}, wall {wall:.4f} s, "
              f"{rec['iters_per_s']:.1f} iters/s, waves {rec['waves']}, "
              f"flat steps {rec['flat_steps']}, host syncs "
              f"{rec['host_syncs']}, launches {rec['launches_by_n']}, "
              f"structural checks worst {worst:.3e} (<= 0 passes)",
              flush=True)
        if not np.all(np.isfinite(res.x.cpu().numpy())):
            raise AssertionError(f"{name}: non-finite solution")
        if worst > 0:
            raise AssertionError(f"{name}: structural check fails by "
                                 f"{worst}")
        require_launched(dict(sl.LAUNCHES), name)
        # the same call on the CPU, the whole bucket (its waves depend on
        # the bucket's active set, so a subset is another computation)
        t0 = time.perf_counter()
        ref = solve_bucket(prob, data, x0b, cfg, torch.device("cpu"))
        rec["card_vs_cpu"] = card_against_cpu(name, res, ref,
                                              time.perf_counter() - t0)
        rec["jax"] = hold_to_jax(f"mixed_{name}", res.signal, res.iter_count,
                                 res.fval, res.x)
        if hit < 0.99:
            # f32 at this size: record, then the same bucket in f64
            cfg64 = cfg.replace(float_dtype="float64")
            r64, w64 = timed(lambda: stack(solve_fleet(
                [prob] * Bn, list(x0b), cfg64, params=params,
                device=device)), counters)
            s64 = r64.signal.cpu().numpy()
            rec["float64"] = dict(
                hit_rate=float(np.mean(np.isin(s64, (1, 2)))),
                mean_iters=float(r64.iter_count.float().mean()),
                max_iters=int(r64.iter_count.max()), wall_s=w64,
                signals={str(k): int(v) for k, v in
                         zip(*np.unique(s64, return_counts=True))},
                launches_by_n=by_n(sl))
            print(f"  {name} again in float64: {rec['float64']}",
                  flush=True)
        out[name] = rec

    # all buckets and one singleton in one call
    spec = get_problem(5)
    x05 = spec.sample_x0(np.random.default_rng(SEED)).astype(np.float32)
    probs, x0s, params, owner = [], [], [], []
    for name, (prob, data, x0b) in buckets.items():
        Bn = x0b.shape[0]
        probs += [prob] * Bn
        x0s += list(x0b)
        params += rows(data, range(Bn))
        owner += [(name, i) for i in range(Bn)]
    probs.append(spec.make())
    x0s.append(x05)
    params.append(())
    results, wall = timed(lambda: solve_fleet(probs, x0s, cfg, params=params,
                                              device=device), counters)
    total = int(sum(int(r.iter_count) for r in results))
    mixed = dict(instances=len(probs), total_iters=total,
                 **run_stats(wall, total, sl, ll, _sync))
    mixed["digests"] = digests(
        torch.stack([r.signal for r in results]),
        torch.stack([r.iter_count for r in results]),
        torch.cat([r.x.reshape(-1) for r in results]))
    print(f"  all buckets digests (sha256 of the bytes): {mixed['digests']}",
          flush=True)
    same = 0
    for (name, i), r in zip(owner, results):
        a = alone[name]
        same += bool(int(r.signal) == int(a.signal[i])
                     and int(r.iter_count) == int(a.iter_count[i])
                     and torch.equal(r.x, a.x[i]))
    single = results[-1]
    dist = spec.distance_to_truth(single.x.cpu().numpy())
    mixed.update(bitwise_equal_to_alone=same, singleton_signal=int(
        single.signal), singleton_iters=int(single.iter_count),
        singleton_distance=dist)
    print(f"  mixed solve_fleet: {len(probs)} instances in "
          f"{len(buckets) + 1} buckets, wall {wall:.4f} s, "
          f"{mixed['iters_per_s']:.1f} iters/s, waves {mixed['waves']}, "
          f"flat steps {mixed['flat_steps']}, host syncs "
          f"{mixed['host_syncs']}, launches {mixed['launches_by_n']}; "
          f"{same}/{len(owner)} bitwise equal to the buckets run alone; "
          f"problem 5: signal {mixed['singleton_signal']} in "
          f"{mixed['singleton_iters']} iterations, distance {dist:.3e}",
          flush=True)
    if int(single.signal) not in (1, 2) or dist > 5e-3:
        raise AssertionError(f"problem 5 in the mixed fleet: signal "
                             f"{int(single.signal)}, distance {dist}")
    require_launched(dict(sl.LAUNCHES), "mixed fleet")
    out["all_buckets"] = mixed
    return out


def observability_phase(problem, cfg, x0, data, wave_fn, ref, counters, sl,
                        _sync):
    """Phase 17: profile_solve on the wave fleet, trace() around a fleet
    solve, trace_metrics on the fleet, and the CLI's --profile."""
    from pyipm_tpu_torch import solve_batch
    from pyipm_tpu_torch.utils.profiling import (
        SCOPES, annotate, iteration_report, profile_solve, trace,
    )

    prof = profile_solve(wave_fn, x0, data, reps=3)
    print("  profile_solve(wave fleet): " + str(prof).replace("\n", "; "),
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        _, t_traced = timed(lambda: _traced(trace, tmp, solve_batch, problem,
                                            x0, cfg, data), ())
        (path,) = [os.path.join(tmp, f) for f in os.listdir(tmp)]
        trace_bytes = os.path.getsize(path)
        with open(path) as fh:
            names = [e.get("name") for e in json.load(fh)["traceEvents"]
                     if e.get("cat") == "user_annotation"]
    missing = [s for s in SCOPES if s not in names]
    scope_count = sum(n in SCOPES for n in names)
    # what a scope costs the host when no profiler runs (record_function
    # and an NVTX range), per entry
    calls = 10_000
    t0 = time.perf_counter()
    for _ in range(calls):
        with annotate("ipm-direction", x0.device):
            pass
    scope_us = (time.perf_counter() - t0) / calls * 1e6
    print(f"  trace() around one fleet solve: {t_traced:.4f} s, "
          f"{trace_bytes} B of Chrome trace, {scope_count} scope entries, "
          f"scopes missing {missing}; a scope costs {scope_us:.2f} us of "
          f"host time outside the profiler ({scope_count * scope_us / 1e3:.3f}"
          f" ms a solve)", flush=True)
    if missing:
        raise AssertionError(f"scopes missing from the trace: {missing}")

    hcfg = cfg.replace(trace_metrics=True)
    solve_batch(problem, x0[:64], hcfg, params=type(data)(
        *(t[:64] for t in data)))                             # warm-up
    hres, wall = timed(lambda: solve_batch(problem, x0, hcfg, params=data),
                       counters)
    hbytes = sum(t.numel() * t.element_size() for t in hres.hist)
    cmp = against_lockstep(ref, hres, "trace_metrics=True")
    last = hres.hist.kkt[0, int(hres.iter_count[0]) - 1]
    print(f"  trace_metrics=True: wall {wall:.4f} s (lockstep "
          f"{ref['wall_s']:.4f} s), history {hbytes} B "
          f"{tuple(hres.hist.kkt.shape)}; instance 0:\n"
          + iteration_report(hres, 0), flush=True)
    if cmp["bitwise_equal"] != B or not torch.equal(last, hres.kkt[0]):
        raise AssertionError("trace_metrics changed the solve, or its last "
                             "row is not the final KKT")

    with tempfile.TemporaryDirectory() as tmp:
        args = ["-m", "pyipm_tpu_torch", "7", "--seed", "42", "--profile",
                tmp]
        proc = subprocess.run([sys.executable] + args, capture_output=True,
                              text=True, timeout=600,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        files = os.listdir(tmp)
        ok = (proc.returncode == 0 and len(files) == 1
              and "Converged to" in proc.stdout)
        if ok:
            with open(os.path.join(tmp, files[0])) as fh:
                text = fh.read()
            ok = all(s in text for s in SCOPES)
    print(f"  python {' '.join(args[:-1])} DIR: exit {proc.returncode}, "
          f"trace files {len(files)}, converged and all scopes present "
          f"{ok}", flush=True)
    if not ok:
        raise AssertionError(f"--profile run failed:\n{proc.stdout[-2000:]}"
                             f"\n{proc.stderr[-2000:]}")
    return dict(profile_solve=dict(first_call_s=prof.compile_s,
                                   execute_s=prof.execute_s,
                                   iters_per_s=prof.iters_per_s,
                                   backend=prof.backend),
                traced_solve_s=t_traced, trace_bytes=trace_bytes,
                scope_entries=scope_count, scope_us=scope_us,
                history_bytes=hbytes, trace_metrics_wall_s=wall,
                trace_metrics_launches=dict(sl.LAUNCHES))


def _traced(trace, logdir, solve_batch, problem, x0, cfg, data):
    with trace(logdir):
        return solve_batch(problem, x0, cfg, params=data)


# ----------------------------------------------------------------------
# phases 19-24: the block-separable Schur solver and what it stands on
SCHUR_FACTOR_SHAPES = ((65_536, 16, 0), (16_384, 17, 1), (4096, 256, 0),
                       (256, 1024, 0))
WEAK = dict(K=65_536, d=16, mc=4)            # schur_weak_scaling.json
LARGE = dict(K=256, d=1024, mc=8)            # schur_largeblock_262k.json
GENERAL_K, RESOURCE_K, RESOURCE_D = 16_384, 16_384, 16
RANKS_K, RANKS_TIMEOUT_S = 8192, 400         # phase 24: 4,096 a rank
# phase 25: benchmarks/bench_lbfgs_block.py:48-70 (schur_lbfgs_largeblock)
LBFGS_BLOCK = dict(K=8, d=65_536, p=4, mem=8, seed=5)
LBFGS_CROSS_D = 4096                           # card against CPU, float64
LBFGS_PEAK_LIMIT = 2 << 30                     # bytes
# phases 21-25 draw every instance on the host from the port's numpy
# samplers, one seed a cell, and hold_block_to_jax holds each solve to the
# JAX package's answer to the same arrays (jax_reference/<cell>.npz,
# scripts/make_jax_reference.py): "instance" the sampler's arguments,
# "config" the IPMConfig of both packages' solves
_F32 = dict(float_dtype="float32", verbosity=0, Ktol=1e-4)
_NO_REFINE = dict(schur_refine_steps=0, schur_refine_guard=False)
_LBFGS = dict(verbosity=0, lbfgs=LBFGS_BLOCK["mem"], niter=20, miter=60)
_RESOURCE = dict(K=RESOURCE_K, d=RESOURCE_D, nres=4, neq=1)
_GENERAL = dict(K=GENERAL_K, d=3, me=1, ni=2, p=2, mc=1)
BLOCK_CELLS = dict(
    schur_weak=dict(phase=21, family="separable", instance=WEAK, seed=SEED,
                    config=dict(_F32, **_NO_REFINE)),
    schur_large=dict(phase=22, family="separable", instance=LARGE,
                     seed=SEED + 1, config=_F32),
    resource_ineq_adaptive=dict(
        phase=23, family="resource", instance=dict(_RESOURCE, cap="ineq"),
        seed=SEED + 2, config=dict(_F32, mu_strategy="adaptive")),
    resource_ineq_mehrotra=dict(
        phase=23, family="resource", instance=dict(_RESOURCE, cap="ineq"),
        seed=SEED + 2, config=dict(_F32, mu_strategy="mehrotra")),
    resource_eq_f64=dict(
        phase=23, family="resource", instance=dict(_RESOURCE, cap="eq"),
        seed=SEED + 2, config=dict(_F32, float_dtype="float64",
                                   mu_strategy="adaptive")),
    block_general_nonlinear=dict(
        phase=23, family="general",
        instance=dict(_GENERAL, nonlinear_cc=True), seed=SEED + 3,
        config=_F32),
    block_general_linear=dict(
        phase=23, family="general",
        instance=dict(_GENERAL, nonlinear_cc=False), seed=SEED + 4,
        config=_F32),
    block_ragged=dict(phase=23, family="ragged",
                      instance=dict(K=GENERAL_K, d=4, me=2, ni=3, p=2, mc=1),
                      seed=SEED + 5, config=_F32),
    schur_ranks=dict(phase=24, family="separable",
                     instance=dict(K=RANKS_K, d=WEAK["d"], mc=WEAK["mc"]),
                     seed=SEED + 6, config=dict(_F32, **_NO_REFINE)),
    lbfgs_block=dict(
        phase=25, family="box_quadratic",
        instance={k: LBFGS_BLOCK[k] for k in ("K", "d", "p")},
        seed=LBFGS_BLOCK["seed"], config=dict(_LBFGS, float_dtype="float32")),
    lbfgs_block_f64=dict(
        phase=25, family="box_quadratic",
        instance=dict(K=LBFGS_BLOCK["K"], d=LBFGS_CROSS_D,
                      p=LBFGS_BLOCK["p"]),
        seed=LBFGS_BLOCK["seed"], config=dict(_LBFGS, float_dtype="float64")),
)
# the x a block cell's reference keeps: whole blocks from block 0 up to
# this many values, or the first BLOCK_X_VALUES / K entries of every block
# where one block is larger
BLOCK_X_VALUES = 16_384
# a float32 block cell: x and the coupling multipliers within this many
# (1 + |.|) at equal iteration counts (STOP_APART_XTOL at others)
BLOCK_F32_XTOL = 2e-3


@contextlib.contextmanager
def plain_kernels(lin, sl, ll):
    """The Schur path's kernel wrappers swapped for their plain versions
    (kernel 1 and kernel 3, as ``ops/linalg`` calls them)."""
    saved = lin.ldlt_factor_small, lin.panel_ldlt
    lin.ldlt_factor_small = sl.ldlt_factor_small_ref
    lin.panel_ldlt = ll.panel_ldlt_ref
    try:
        yield
    finally:
        lin.ldlt_factor_small, lin.panel_ldlt = saved


def busy_share(fn):
    """(result, device busy ms, wall s, idle share) of one call of ``fn``
    under ``torch.profiler``: the device's self time (kernels, copies,
    memsets) over the call's wall (the profiler's own cost included in
    the wall).  It records the device's activity alone: with the host's
    too the busy ms read the same, but a host-bound solve's thousands of
    host events take the profiler many times as long to process
    (``scripts/time_f64_phase.py --profiler-cost`` times both)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only; the solver's "ipm-*" scopes show on the
    # device too, as annotation spans over kernels already counted
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and not e.key.startswith("ipm-"))
    return out, us / 1e3, wall, 1.0 - us / 1e6 / wall


def schur_blocks(gen, Bn, n, neq, device):
    """Bn f32 condensed blocks [[W, Je^T], [Je, 0]] made on the card:
    W = G G^T/d + I, and W - 2I (eigenvalues in about [-1, 3]: the wrong
    inertia, escalated) for every 5th block; with neq > 0 a zero row in
    Je of every 7th block (the eq regularization)."""
    d = n - neq
    G = torch.randn(Bn, d, d, generator=gen, device=device) / d ** 0.5
    eye = torch.eye(d, device=device)
    bad = (torch.arange(Bn, device=device) % 5 == 2)[:, None, None]
    W = G @ G.mT + eye - 2.0 * eye * bad
    H = torch.zeros(Bn, n, n, device=device)
    H[:, :d, :d] = W
    if neq:
        Je = torch.randn(Bn, neq, d, generator=gen, device=device)
        Je[torch.arange(Bn, device=device) % 7 == 3, 0] = 0.0
        H[:, d:, :d] = Je
        H[:, :d, d:] = Je.mT
    return (H + H.mT) / 2


def normwise_backward_error(A, x, b):
    """Per block ||A x - b|| / (||A||_F ||x|| + ||b||), in float64."""
    A, x, b = A.double(), x.double(), b.double()
    r = torch.linalg.vector_norm(A @ x - b, dim=(-2, -1))
    return r / (torch.linalg.matrix_norm(A) * torch.linalg.vector_norm(
        x, dim=(-2, -1)) + torch.linalg.vector_norm(b, dim=(-2, -1)))


def schur_factor_phase(lin, sl, ll, cfg, device):
    """Phase 19: ``batched_reg_factor`` with the kernels against the same
    call on the plain versions, and kernels 1 and 3 bitwise at the Schur
    shapes; timings of kernel 1 at (65536, 16), (16384, 17) and of the
    batched kernel 3 at (256, 128, 128)."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    kw = dict(eps=cfg.eps, reg_coef=cfg.reg_coef, eta=cfg.eta, beta=cfg.beta,
              delta0=cfg.delta0, max_retries=cfg.max_reg_retries)
    mu = torch.tensor(0.1, device=device)
    out = {}
    for Bn, n, neq in SCHUR_FACTOR_SHAPES:
        H = schur_blocks(gen, Bn, n, neq, device)
        delta = torch.zeros(Bn, device=device)
        delta[::3] = 1e-3
        b = torch.randn(Bn, n, 2, generator=gen, device=device)
        res = {}
        for name, ctx in (("kernel", contextlib.nullcontext()),
                          ("plain", plain_kernels(lin, sl, ll))):
            with ctx:
                reset(sl.LAUNCHES, sl.LAUNCHES_BY_N, ll.LAUNCHES,
                      ll.LAUNCHES_BY_B)
                solve, dn, r, (da, eq) = lin.batched_reg_factor(
                    H, delta, mu, neq=neq, **kw)
                x = solve(b)
                torch.cuda.synchronize()
                res[name] = dict(x=x, dn=dn, r=r, da=da, eq=eq,
                                 k1=sl.LAUNCHES["factor"],
                                 k3={str(k[1]): v for k, v in
                                     ll.LAUNCHES_BY_B.items() if v})
        kr, pr = res["kernel"], res["plain"]
        for k in ("dn", "da", "eq"):
            if not same_bits(kr[k], pr[k]):
                raise AssertionError(f"batched_reg_factor ({Bn}, {n}): "
                                     f"{k} differs from the plain path's")
        if kr["r"] != pr["r"] or kr["r"] == 0:
            raise AssertionError(f"batched_reg_factor ({Bn}, {n}): retries "
                                 f"{kr['r']} against {pr['r']}")
        ex = (torch.arange(n, device=device) < n - neq).float()
        A = (H + kr["da"][:, None, None] * torch.diag(ex)
             - kr["eq"][:, None, None] * torch.diag(1 - ex))
        bk = normwise_backward_error(A, kr["x"], b)
        bp = normwise_backward_error(A, pr["x"], b)
        worst = float((bk / torch.clamp(bp, min=n * cfg.eps)).max())
        if not worst <= 1.0 + 1e-6:
            raise AssertionError(f"batched_reg_factor ({Bn}, {n}): backward "
                                 f"error {float(bk.max())} above the plain "
                                 f"path's {float(bp.max())}")
        bad = int((kr["da"] > 0).sum())
        print(f"  ok batched_reg_factor ({Bn}, {n}), neq {neq}: delta_new, "
              f"applied shifts and eq shifts bitwise equal to the plain "
              f"path's, {kr['r']} retries ({bad} blocks escalated, "
              f"{int((kr['eq'] > 0).sum())} eq-regularized); backward error "
              f"max {float(bk.max()):.3e} (plain {float(bp.max()):.3e}, "
              f"n eps {n * cfg.eps:.3e}); kernel 1 launches "
              f"{kr['k1']}, kernel 3 launches by B {kr['k3']}", flush=True)
        out[f"{Bn}x{n}"] = dict(retries=kr["r"], escalated=bad,
                                backward_error=float(bk.max()),
                                kernel1_launches=kr["k1"],
                                kernel3_launches_by_b=kr["k3"])
        del H, res, kr, pr, A

    # the kernels themselves, bitwise at these shapes
    rec = {}
    for Bn, n in ((65_536, 16), (16_384, 17)):
        A = rand_sym(torch.Generator().manual_seed(n), Bn, n, torch.float32,
                     device)
        L, d = sl.ldlt_factor_small(A)
        Lr, dr = sl.ldlt_factor_small_ref(A)
        if not (same_bits(L, Lr) and same_bits(d, dr)):
            raise AssertionError(f"kernel 1 at ({Bn}, {n}) differs from "
                                 f"its plain version")
        rec[f"ldlt_factor_small_{Bn}x{n}"] = dict(
            max_abs_err=0.0,
            ms=cuda_ms(lambda: sl.ldlt_factor_small(A), REPS),
            device_ms=device_ms(lambda: sl.ldlt_factor_small(A),
                                ("ldlt_factor_kernel",)),
            plain_ms=cuda_ms(lambda: sl.ldlt_factor_small_ref(A), 3),
            library_ms=None, bound=factor_bound(Bn, n), shape=[Bn, n])
        print(f"  ok kernel 1 at ({Bn}, {n}): bitwise equal to "
              f"ldlt_factor_small_ref", flush=True)
    # the batched kernel 3 at the wave edges of its variants (panels_per_sm
    # switches above the SM count) and at phase 26's batch, on random,
    # indefinite (rand_sym's every 7th) and exact-zero-pivot panels (every
    # 11th), in f32 and f64
    sms = ll.sm_count(device)
    for dtype in (torch.float32, torch.float64):
        Q = rand_sym(torch.Generator().manual_seed(11), max(PANEL_BATCHES),
                     128, dtype, device)
        Q[5::11] = torch.as_tensor(exact_zero_pivot_panel(128, 5),
                                   dtype=dtype, device=device)
        for Bn in PANEL_BATCHES:
            Pb = Q[:Bn].contiguous()
            L, d = ll.panel_ldlt(Pb)
            Lr, dr = ll.panel_ldlt_ref(Pb)
            if not (same_bits(L, Lr) and same_bits(d, dr)):
                bad = [i for i in range(Bn)
                       if not (same_bits(L[i], Lr[i])
                               and same_bits(d[i], dr[i]))]
                raise AssertionError(f"batched kernel 3 (B = {Bn}, {dtype})"
                                     f" differs from panel_ldlt_ref at "
                                     f"panels {bad[:10]}")
            if Bn == 256 and dtype == torch.float32:
                # the batched reference against the reference panel by
                # panel
                for i in range(Bn):
                    Li, di = ll.panel_ldlt_ref(Pb[i])
                    if not (same_bits(Li, Lr[i]) and same_bits(di, dr[i])):
                        raise AssertionError(f"panel_ldlt_ref batched "
                                             f"differs from panel {i} alone")
            for i in {0, Bn - 1}:
                L1, d1 = ll.panel_ldlt(Pb[i])
                if not (same_bits(L1, L[i]) and same_bits(d1, d[i])):
                    raise AssertionError("kernel 3 on one panel differs "
                                         "from the same panel in a batch")
            print(f"  ok batched kernel 3 at ({Bn}, 128, 128), {dtype}, "
                  f"{ll.panels_per_sm(Bn, sms, dtype)} panels an SM ({sms} "
                  f"SMs): bitwise equal to panel_ldlt_ref", flush=True)
        del Q
    residency = {per_sm: ll.panel_residency(per_sm, torch.float32, device)
                 for per_sm in (1, 2)}
    print(f"  kernel 3, f32, n = 128: the one-panel variant {residency[1]} "
          f"CTAs (panels) resident an SM, the two-panel variant "
          f"{residency[2]}, by the occupancy calculator", flush=True)
    if residency[2] < 2:
        raise AssertionError("the two-panel variant of kernel 3 does not "
                             "put two panels on an SM")
    P = rand_sym(torch.Generator().manual_seed(7), LARGE["K"], 128,
                 torch.float32, device)
    rec["panel_ldlt_batched"] = dict(
        max_abs_err=0.0, ms=cuda_ms(lambda: ll.panel_ldlt(P), REPS),
        device_ms=device_ms(lambda: ll.panel_ldlt(P), ("panel_ldlt_kernel",)),
        plain_ms=cuda_ms(lambda: ll.panel_ldlt_ref(P), 3), library_ms=None,
        bound=factor_bound(LARGE["K"], 128), shape=[LARGE["K"], 128, 128],
        panels_resident_per_sm=residency)
    Bw = WIDE_PORTFOLIO["B"]
    P = rand_sym(torch.Generator().manual_seed(7), Bw, 128, torch.float32,
                 device)
    rec[f"panel_ldlt_batched_{Bw}"] = dict(
        max_abs_err=0.0, ms=cuda_ms(lambda: ll.panel_ldlt(P), REPS),
        device_ms=device_ms(lambda: ll.panel_ldlt(P), ("panel_ldlt_kernel",)),
        plain_ms=cuda_ms(lambda: ll.panel_ldlt_ref(P), 3), library_ms=None,
        bound=factor_bound(Bw, 128), shape=[Bw, 128, 128])
    del P
    for name, r in rec.items():
        print(f"  f32 {name} at {r['shape']}: {r['ms']:.4f} ms per call, "
              f"device {r['device_ms'][0]:.4f} ms per launch "
              f"({r['device_ms'][2]} launches per call, by "
              f"{r['device_ms'][1]}), plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound'][0]:.5f} ms by {r['bound'][1]}", flush=True)
    reset(sl.LAUNCHES, sl.LAUNCHES_BY_N, ll.LAUNCHES, ll.LAUNCHES_BY_B)
    return out, rec


def draw_block(cell):
    """A Schur cell's instance on the host, drawn by the port's numpy
    sampler of its family: {"theta": ..., "ccdata": ...}, or the fields
    of ``SeparableData`` for the separable family."""
    from pyipm_tpu_torch.models import applications as A
    from pyipm_tpu_torch.parallel import schur as S
    c = BLOCK_CELLS[cell]
    z, seed = c["instance"], c["seed"]
    dt = np.dtype(c["config"]["float_dtype"])
    if c["family"] == "separable":
        return S.sample_separable_arrays(seed, z["K"], z["d"], z["mc"], dt)
    if c["family"] == "resource":
        th, cc = A.sample_resource_alloc_arrays(seed, z["K"], z["d"],
                                                z["nres"], z["neq"], dt)
    elif c["family"] == "general":
        th, cc = S.sample_block_general_arrays(
            seed, z["K"], z["d"], z["me"], z["ni"], z["p"], dt)
    elif c["family"] == "ragged":
        th, cc, _, _ = S.sample_block_ragged_arrays(
            seed, z["K"], z["d"], z["me"], z["ni"], z["p"], dt)
    else:
        th, cc = S.sample_block_box_quadratic_arrays(seed, z["K"], z["d"],
                                                     z["p"], dt)
    return dict(theta=th, ccdata=cc)


def input_digests(arrays, prefix=""):
    """{"theta/Q": sha256 of the array's dtype, shape and bytes, ...} of
    a nested dict of numpy arrays."""
    out = {}
    for k, v in arrays.items():
        if isinstance(v, dict):
            out.update(input_digests(v, f"{prefix}{k}/"))
        else:
            v = np.ascontiguousarray(v)
            h = hashlib.sha256(f"{v.dtype.str}{v.shape}".encode())
            h.update(memoryview(v).cast("B"))
            out[prefix + k] = h.hexdigest()
    return out


def block_problem(cell, arrays, device):
    """(spec, theta, ccdata, x0) of a Schur cell for the port's
    ``make_block_solver`` on ``device``, from ``draw_block``'s arrays."""
    from pyipm_tpu_torch import interop
    from pyipm_tpu_torch.models import applications as A
    from pyipm_tpu_torch.parallel import schur as S
    c = BLOCK_CELLS[cell]
    z = c["instance"]
    dt = getattr(torch, c["config"]["float_dtype"])
    x0 = torch.zeros((z["K"], z["d"]), dtype=dt, device=device)
    if c["family"] == "separable":
        data = interop.separable_data_from_numpy(arrays, device=device)
        return (S.separable_block_spec(S.separable_spec(z["d"], z["mc"])),
                {"user": data.theta, "A": data.A, "lb": data.lb},
                {"b": data.b}, x0)
    th, cc = interop.block_data_from_numpy(arrays["theta"],
                                           arrays["ccdata"], device=device)
    if c["family"] == "resource":
        return (A.make_resource_alloc_spec(z["d"], z["nres"], z["neq"],
                                           cap=z["cap"]), th, cc, x0 + 1)
    if c["family"] == "general":
        spec = S.block_general_spec(z["d"], z["me"], z["ni"], z["p"],
                                    z["mc"], nonlinear_cc=z["nonlinear_cc"])
    elif c["family"] == "ragged":
        spec = S.block_ragged_spec(z["d"], z["me"], z["ni"], z["p"],
                                   z["mc"])
    else:
        spec = S.block_box_quadratic_spec(z["d"], z["p"])
    return spec, th, cc, x0


def block_x_layout(K, d):
    """(blocks, entries a block) of the x a block cell's reference keeps:
    whole blocks from block 0 up to BLOCK_X_VALUES values, or the first
    BLOCK_X_VALUES // K entries of every block where d is larger."""
    if d <= BLOCK_X_VALUES:
        return min(K, BLOCK_X_VALUES // d), d
    return K, BLOCK_X_VALUES // K


def hold_block_to_jax(cell, digests, res, what="the card"):
    """Hold one Schur solve (a result with signal, iter_count, fval, x, lc
    and lci) to the JAX package's answer (``jax_reference``): first the
    instance, ``digests`` (``input_digests`` of the arrays the phase
    drew) against the manifest's; then the signal equal (unless
    JAX_SIGNAL_SPLITS classifies the cell's solve, index 0); in float64
    the iteration count equal and x, the coupling multipliers and f within
    JAX_F64_TOL (1 + |.|); in float32 x and the coupling multipliers
    within BLOCK_F32_XTOL (1 + |.|) at equal iteration counts and
    STOP_APART_XTOL at others, f within JAX_FTOL (1 + |f|), the counts
    printed beside the reference's and not held.  Where the signals split
    as classified, x, the multipliers and f are still held, within
    STOP_APART_XTOL."""
    t0 = time.perf_counter()
    entry, ref = jax_reference(cell)
    bad = {k: (v, digests.get(k)) for k, v in entry["inputs"].items()
           if digests.get(k) != v}
    if bad or set(digests) != set(entry["inputs"]):
        raise AssertionError(f"{cell}: the drawn instance is not the "
                             f"reference's (sha256 of {sorted(bad)}, arrays "
                             f"{sorted(digests)})")

    def host(t):
        t = t.detach().cpu() if torch.is_tensor(t) else t
        return np.asarray(t, dtype=np.float64)

    sg, ig = int(res.signal), int(res.iter_count)
    sr, ir = int(ref["signal"]), int(ref["iter_count"])
    fg, fr = float(res.fval), float(ref["f"])
    nb, nc = ref["x"].shape
    xg, xr = host(res.x)[:nb, :nc], ref["x"].astype(np.float64)
    mult = [(host(getattr(res, k)).reshape(-1), ref[k].astype(np.float64))
            for k in ("lc", "lci")]
    f64 = entry["dtype"] == "float64"
    if f64:
        xtol = ftol = JAX_F64_TOL
    else:
        xtol = BLOCK_F32_XTOL if (ig, sg) == (ir, sr) else max(
            BLOCK_F32_XTOL, STOP_APART_XTOL)
        ftol = JAX_FTOL

    def rel(a, b):
        if a.shape != b.shape:
            raise AssertionError(f"{cell}: shape {a.shape} against the "
                                 f"reference's {b.shape}")
        return float((np.abs(a - b) / (1.0 + np.abs(b))).max(initial=0.0))

    dx, dl = rel(xg, xr), max(rel(a, b) for a, b in mult)
    df = abs(fg - fr) / (1.0 + abs(fr))
    out = dict(jax_path=entry["jax_path"], signal=sg, jax_signal=sr,
               iters=ig, jax_iters=ir, max_rel_dx=dx, max_rel_dlc=dl,
               rel_df=df, x_values_held=int(xr.size), xtol=xtol,
               hold_s=time.perf_counter() - t0)
    print(f"  {cell}, {what} against the JAX package ({entry['jax_path']})"
          f": inputs equal ({len(digests)} sha256); signal {sg}, JAX {sr}; "
          f"iterations {ig}, JAX {ir} ({'held' if f64 else 'recorded'}); "
          f"max |dx|/(1+|x|) {dx:.3e} over {xr.size} values, coupling "
          f"multipliers {dl:.3e}, |df|/(1+|f|) {df:.3e} (held within "
          f"{xtol}, f {ftol}); kkt "
          f"{np.array2string(host(res.kkt), precision=3)}, JAX "
          f"{np.array2string(ref['kkt'], precision=3)}; "
          f"{out['hold_s']:.3f} s", flush=True)
    classified = sg != sr and 0 in JAX_SIGNAL_SPLITS.get(cell, ())
    if sg != sr and not classified:
        raise AssertionError(f"{cell}: signal {sg} against the JAX "
                             f"package's {sr}, classified nowhere (ROADMAP "
                             f"Queue 3)")
    if f64 and ig != ir:
        raise AssertionError(f"{cell}: {ig} iterations against the JAX "
                             f"package's {ir} in float64")
    held = classified or (sg in (1, 2) and sr in (1, 2))
    if held and (dx > xtol or dl > xtol or df > ftol):
        raise AssertionError(f"{cell}: x {dx}, coupling multipliers {dl} "
                             f"beyond {xtol} (1+|.|) or f {df} beyond "
                             f"{ftol} (1+|f|)")
    return out


def block_solve(fn, x0, theta, ccdata, counters, sl, ll, _sync, what,
                signals=(1,), profile_iters=3):
    """One timed solve of a block solver (its counters reset just before),
    then its first ``profile_iters`` inner iterations again under
    ``torch.profiler`` for the device's busy share.  Raises unless the
    signal is one of ``signals`` (and, at signal 1, every KKT norm is at
    most Ktol)."""
    red = fn.reducer
    calls0 = red.total
    res, wall = timed(lambda: fn(x0, theta, ccdata), counters)
    calls = red.total - calls0
    sig, its = int(res.signal), int(res.iter_count)
    kkt = res.kkt.cpu().numpy()
    out = dict(signal=sig, iters=its, kkt=kkt.tolist(), wall_s=wall,
               flat_steps=_sync.COUNTS["flat_steps"],
               host_syncs=_sync.COUNTS["host_syncs"],
               all_reduces=calls, all_reduces_per_iter=calls / max(its, 1),
               kernel1_by_n=by_n(sl),
               kernel3_by_b={str(k[1]): v
                             for k, v in ll.LAUNCHES_BY_B.items() if v},
               launches={**sl.LAUNCHES, **ll.LAUNCHES},
               max_memory_bytes=torch.cuda.max_memory_allocated(),
               digests=digests(res.signal, res.iter_count, res.x))
    st0 = fn.init_state(x0, theta, ccdata)
    _, busy, pwall, idle = busy_share(
        lambda: fn.run_budget(st0, theta, ccdata, profile_iters))
    out.update(profiled_iters=profile_iters, busy_ms=busy,
               profiled_wall_s=pwall, idle_share=idle)
    print(f"  {what}: signal {sig} iterations {its} kkt "
          f"{np.array2string(kkt, precision=3)} wall {wall:.3f} s flat "
          f"steps {out['flat_steps']} host syncs {out['host_syncs']} "
          f"all-reduces {calls} ({out['all_reduces_per_iter']:.2f} an "
          f"iteration) kernel 1 launches by n {out['kernel1_by_n']} kernel "
          f"3 launches by B {out['kernel3_by_b']} max memory "
          f"{out['max_memory_bytes']} B, digests {out['digests']}; first "
          f"{profile_iters} iterations "
          f"profiled: device busy {busy:.1f} ms of {pwall:.3f} s (idle "
          f"{100 * idle:.1f}%)", flush=True)
    if sig not in signals:
        raise AssertionError(f"{what}: signal {sig}, kkt {kkt}")
    if sig == 1 and not np.all(kkt <= fn.config.Ktol):
        raise AssertionError(f"{what}: signal 1 with kkt {kkt} above Ktol")
    if not bool(torch.isfinite(res.x).all()):
        raise AssertionError(f"{what}: x is not finite")
    return res, out


def separable_phase(S, cell, counters, sl, ll, _sync, device,
                    need_k1=False, need_k3=False):
    """Phases 21-22: the separable cell ``cell`` (BLOCK_CELLS), drawn by
    ``sample_separable_arrays`` on the host, through the separable solver
    at world size 1, held to the JAX package's answer."""
    from pyipm_tpu_torch import IPMConfig
    inst = BLOCK_CELLS[cell]["instance"]
    cfg = IPMConfig(**BLOCK_CELLS[cell]["config"])
    arrays = draw_block(cell)
    digests = input_digests(arrays)
    _, theta, cc, x0 = block_problem(cell, arrays, device)
    del arrays
    fn = S.make_block_solver(S.separable_block_spec(S.separable_spec(
        inst["d"], inst["mc"])), None, cfg, device=device)
    torch.cuda.reset_peak_memory_stats()
    res, out = block_solve(fn, x0, theta, cc, counters, sl, ll, _sync,
                           f"K={inst['K']} d={inst['d']} mc={inst['mc']} "
                           f"({inst['K'] * inst['d']} variables, "
                           f"{cfg.float_dtype})")
    if need_k1 and not out["kernel1_by_n"].get("factor", {}).get(
            str(inst["d"])):
        raise AssertionError(f"kernel 1 was not launched at n = {inst['d']}:"
                             f" {out['kernel1_by_n']}")
    if need_k3 and not out["kernel3_by_b"].get(str(inst["K"])):
        raise AssertionError(f"the batched kernel 3 was not launched at B = "
                             f"{inst['K']}: {out['kernel3_by_b']}")
    out["jax"] = hold_block_to_jax(cell, digests, res)
    del res, theta
    return out


def general_phase(S, counters, sl, ll, _sync, device):
    """Phase 23: resource allocation (16,384 agents x 16 variables, 4
    resources, 1 equality: n = 17) with a cap under 'adaptive' and
    'mehrotra', and with a binding pool in float64 (in float32 the JAX
    package stalls on it too: the border's Tikhonov term sqrt(eps) swamps
    the pool rows of R_k ~ 1/(K d), ROADMAP Queue 3); the general block
    NLP (K = 16,384, d = 3) with nonlinear and with linear coupling; the
    ragged one; and the capped one paused by run_budget(3), saved,
    restored and resumed.  Every instance drawn on the host by its numpy
    sampler, every solve held to the JAX package's answer."""
    from pyipm_tpu_torch import IPMConfig
    out = {}
    ok = (1, 2)
    for cell in ("resource_ineq_adaptive", "resource_ineq_mehrotra",
                 "resource_eq_f64", "block_general_nonlinear",
                 "block_general_linear", "block_ragged"):
        c = IPMConfig(**BLOCK_CELLS[cell]["config"])
        z = BLOCK_CELLS[cell]["instance"]
        arrays = draw_block(cell)
        digests = input_digests(arrays)
        spec, th, cc, x0 = block_problem(cell, arrays, device)
        fn = S.make_block_solver(spec, None, c, device=device)
        what = (f"resource allocation cap={z['cap']} {c.mu_strategy} "
                f"{c.float_dtype}" if "cap" in z else
                f"block NLP K={z['K']} d={z['d']} {cell}")
        res, out[cell] = block_solve(fn, x0, th, cc, counters, sl, ll,
                                     _sync, what, signals=ok)
        if "cap" in z:
            if not out[cell]["kernel1_by_n"].get("factor", {}).get("17"):
                raise AssertionError(f"{cell}: kernel 1 was not launched "
                                     f"at n = 17")
            pool = torch.einsum("krd,kd->r", th["R"], res.x)
            over = float((pool - cc["budget"]).abs().max()
                         if z["cap"] == "eq" else (pool - cc["budget"]).max())
            if over > 1e-3 * float(cc["budget"].abs().max()):
                raise AssertionError(f"{cell}: the pool is off by {over}")
        out[cell]["jax"] = hold_block_to_jax(cell, digests, res)
        if cell == "resource_ineq_adaptive":
            kept = fn, th, cc, x0, digests

    # pause -> save -> restore -> resume the capped resource allocation
    from pyipm_tpu_torch.utils.checkpoint import restore_state, save_state
    cell = "resource_ineq_adaptive"
    fn, th, cc, x0, digests = kept
    straight = out[cell]
    st = fn.run_budget(fn.init_state(x0, th, cc), th, cc,
                       max_new_iters=BUDGET)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "block")
        save_state(path, st)
        nbytes = os.path.getsize(path + ".npz")
        st2 = restore_state(path, fn.init_state(x0, th, cc))
    res = fn.finalize(fn.run(st2, th, cc), th, cc)
    resumed = dict(signal=int(res.signal), iters=int(res.iter_count),
                   checkpoint_bytes=nbytes)
    print(f"  capped resource allocation paused at {BUDGET}, saved "
          f"({nbytes} B), restored, resumed: signal {resumed['signal']} "
          f"iterations {resumed['iters']} (straight: {straight['signal']}, "
          f"{straight['iters']})", flush=True)
    if (resumed["signal"], resumed["iters"]) != (straight["signal"],
                                                 straight["iters"]):
        raise AssertionError("the resumed block solve differs from the "
                             "straight one")
    resumed["jax"] = hold_block_to_jax(cell, digests, res,
                                       "the resumed solve")
    out["resumed"] = resumed
    return out


def rank_worker(out_path, device="cuda"):
    """Phase 24's worker, one rank of ``launch --spawn N``: joins on gloo
    (NCCL refuses two ranks on one card; gloo all-reduces the card's
    tensors through the host), draws the whole ``schur_ranks`` instance,
    solves it split over the ranks, one iteration at a time to count each
    iteration's all-reduces, and rank 0 writes the result."""
    from pyipm_tpu_torch.parallel import distributed as dist
    from pyipm_tpu_torch.parallel import schur as S
    device = torch.device(device)
    dist.initialize(device=device, backend="gloo")
    mesh = dist.global_solver_mesh(batch=1, model=dist.world_size(),
                                   device=device)
    out = ranks_solve(S, mesh, device)
    if dist.rank() == 0:
        np.savez(out_path, **out)
    dist.shutdown()


def ranks_solve(S, mesh, device):
    """The ``schur_ranks`` cell (phase 21's family at K = RANKS_K, without
    refinement), drawn whole on the host by ``sample_separable_arrays``
    (each rank solves its share of the blocks), solved one inner
    iteration at a time: x, f, the coupling multipliers, signal,
    iterations, wall, the all-reduces of each iteration and the input
    digests."""
    from pyipm_tpu_torch import IPMConfig
    cell = "schur_ranks"
    cfg = IPMConfig(**BLOCK_CELLS[cell]["config"])
    arrays = draw_block(cell)
    digests = input_digests(arrays)
    spec, theta, cc, x0 = block_problem(cell, arrays, device)
    fn = S.make_block_solver(spec, mesh, cfg, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = fn.init_state(x0, theta, cc)
    calls = []
    while int(st.signal[0]) == 0 and int(st.outer[0]) < cfg.niter:
        before = fn.reducer.total
        st = fn.run_budget(st, theta, cc, max_new_iters=1)
        calls.append(fn.reducer.total - before)
    res = fn.finalize(st, theta, cc)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return dict(x=res.x.cpu().numpy(), fval=float(res.fval),
                lc=res.lc.cpu().numpy(), lci=res.lci.cpu().numpy(),
                kkt=res.kkt.cpu().numpy(), signal=int(res.signal),
                iters=int(res.iter_count), calls=np.asarray(calls),
                wall_s=time.perf_counter() - t0,
                digests=json.dumps(digests))


def _ranks_result(r):
    """A ``ranks_solve`` record as the fields ``hold_block_to_jax``
    reads."""
    import types
    return types.SimpleNamespace(
        signal=int(r["signal"]), iter_count=int(r["iters"]),
        fval=float(r["fval"]), x=r["x"], lc=r["lc"], lci=r["lci"],
        kkt=r["kkt"])


def ranks_phase(S, device):
    """Phase 24: two ranks on the card through the launcher (gloo), the
    ``schur_ranks`` cell (phase 21's family at K = 8,192) against one
    process and both against the JAX package, and the batch-axis fleet
    of examples/distributed_fleet.py at 2 ranks against 1."""
    one = ranks_solve(S, None, device)
    repo = os.path.dirname(os.path.abspath(__file__))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ranks.npz")
        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable, "-m", "pyipm_tpu_torch.parallel.launch",
             "--spawn", "2", "--timeout", str(RANKS_TIMEOUT_S),
             os.path.abspath(__file__), "--rank-worker", path,
             device.type],
            cwd=repo, check=True, timeout=RANKS_TIMEOUT_S + 60)
        launch_s = time.perf_counter() - t0
        with np.load(path) as f:
            two = dict(f)
        fleets = {}
        for n in (1, 2):
            fp = os.path.join(tmp, f"fleet{n}.npz")
            subprocess.run(
                [sys.executable, "-m", "pyipm_tpu_torch.parallel.launch",
                 "--spawn", str(n), "--timeout", str(RANKS_TIMEOUT_S),
                 "pyipm_tpu_torch/examples/distributed_fleet.py",
                 "--device", device.type, "--backend", "gloo", "--out",
                 fp],
                cwd=repo, check=True, timeout=RANKS_TIMEOUT_S + 60)
            with np.load(fp) as f:
                fleets[n] = dict(f)
    x1, x2 = one["x"], two["x"]
    dx = float(np.max(np.abs(x2 - x1) / (1 + np.abs(x1))))
    out = dict(signal_1=one["signal"], iters_1=one["iters"],
               signal_2=int(two["signal"]), iters_2=int(two["iters"]),
               max_dx=dx, wall_1_s=one["wall_s"],
               wall_2_s=float(two["wall_s"]), launch_2_s=launch_s,
               all_reduces_per_iter_1=one["calls"].tolist(),
               all_reduces_per_iter_2=two["calls"].tolist())
    print(f"  K={RANKS_K} d={WEAK['d']} mc={WEAK['mc']}: 1 rank signal "
          f"{one['signal']} iterations {one['iters']} wall "
          f"{one['wall_s']:.3f} s; 2 ranks (gloo) signal {out['signal_2']} "
          f"iterations {out['iters_2']} wall {out['wall_2_s']:.3f} s (the "
          f"launch {launch_s:.1f} s); max |dx|/(1+|x|) {dx:.3e}; "
          f"all-reduces an iteration {out['all_reduces_per_iter_2']}",
          flush=True)
    if (out["signal_2"], out["iters_2"]) != (one["signal"], one["iters"]):
        raise AssertionError("two ranks differ from one in signal or "
                             "iterations")
    if one["signal"] != 1 or not dx <= 1e-4:
        raise AssertionError(f"two ranks: signal {one['signal']}, max dx "
                             f"{dx}")
    if out["all_reduces_per_iter_1"] != out["all_reduces_per_iter_2"]:
        raise AssertionError("two ranks asked for other all-reduces")
    digests = json.loads(one["digests"])
    if json.loads(str(two["digests"])) != digests:
        raise AssertionError("rank 0 drew another instance than the one "
                             "process")
    out["jax_1"] = hold_block_to_jax("schur_ranks", digests,
                                     _ranks_result(one), "one rank")
    out["jax_2"] = hold_block_to_jax("schur_ranks", digests,
                                     _ranks_result(two), "two ranks")
    same = all(np.array_equal(fleets[1][k], fleets[2][k])
               for k in ("signal", "iter_count"))
    out["fleet_equal"] = same
    out["fleet_max_dx"] = float(np.max(np.abs(fleets[1]["x"]
                                              - fleets[2]["x"])))
    print(f"  distributed_fleet at 2 ranks against 1: signals and "
          f"iterations equal {same}, max |dx| {out['fleet_max_dx']:.3e}",
          flush=True)
    if not same:
        raise AssertionError("the batch-axis fleet at 2 ranks differs from "
                             "1 rank")
    return out


def lbfgs_block_phase(S, counters, sl, ll, _sync, device):
    """Phase 25: the per-block L-BFGS mode at the JAX package's
    large-block width (K = 8 blocks of d = 65,536, p = mc = 4, L-BFGS(8),
    float32): signal 1 or 2, no kernel launched, the peak allocation
    under LBFGS_PEAK_LIMIT; the same family at d = LBFGS_CROSS_D in
    float64 on the card and on the CPU (signal and iterations equal, x
    within 1e-8), each held to the JAX package's answer (the CPU's too);
    and examples/block_lbfgs_and_ragged.py on the card.  The instances
    are ``lbfgs_block`` and ``lbfgs_block_f64`` of BLOCK_CELLS, drawn on
    the host by ``sample_block_box_quadratic_arrays``."""
    from pyipm_tpu_torch import IPMConfig
    from pyipm_tpu_torch.examples import block_lbfgs_and_ragged
    cell = "lbfgs_block"
    K, d, p = (BLOCK_CELLS[cell]["instance"][k] for k in ("K", "d", "p"))
    cfg = IPMConfig(**BLOCK_CELLS[cell]["config"])
    arrays = draw_block(cell)
    digests = input_digests(arrays)
    spec, theta, ccdata, x0 = block_problem(cell, arrays, device)
    del arrays
    fn = S.make_block_solver(spec, None, cfg, device=device)
    # the first calls of this path's library routines load their modules:
    # an initial state and 2 iterations first, so the timed solve is warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn.run_budget(fn.init_state(x0, theta, ccdata), theta, ccdata, 2)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    res, out = block_solve(fn, x0, theta, ccdata, counters, sl, ll, _sync,
                           f"L-BFGS({cfg.lbfgs}) K={K} d={d} mc={p} "
                           f"({K * d} variables, float32)", signals=(1, 2))
    out["warm_up_s"] = warm_s
    dense_bytes = K * d * d * 4
    its = max(out["iters"], 1)
    print(f"  per inner iteration: flat steps {out['flat_steps'] / its:.2f}"
          f", host syncs {out['host_syncs'] / its:.2f}, all-reduces "
          f"{out['all_reduces_per_iter']:.2f}; peak allocation "
          f"{out['max_memory_bytes']} B (a dense per-block Hessian alone: "
          f"{dense_bytes} B); kernel launches {out['launches']}; the "
          f"warm-up (initial state and 2 iterations) {warm_s:.3f} s",
          flush=True)
    if any(out["launches"].values()):
        raise AssertionError(f"the L-BFGS path launched a kernel: "
                             f"{out['launches']}")
    if not out["max_memory_bytes"] < LBFGS_PEAK_LIMIT:
        raise AssertionError(f"peak allocation {out['max_memory_bytes']} B "
                             f">= {LBFGS_PEAK_LIMIT} B")
    out["jax"] = hold_block_to_jax(cell, digests, res)
    del theta, ccdata, x0, fn, res

    # the card against the CPU path on the same data, float64
    cell = "lbfgs_block_f64"
    c64 = IPMConfig(**BLOCK_CELLS[cell]["config"])
    arrays = draw_block(cell)
    digests = input_digests(arrays)
    spec, theta, ccdata, x0 = block_problem(cell, arrays, device)
    walls, res = {}, {}
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        th = {k: v.to(dev) for k, v in theta.items()}
        cc = {k: v.to(dev) for k, v in ccdata.items()}
        t0 = time.perf_counter()
        res[where] = S.make_block_solver(spec, None, c64, device=dev)(
            x0.to(dev), th, cc)
        walls[where] = time.perf_counter() - t0
    xg, xc = res["card"].x.cpu().numpy(), res["cpu"].x.numpy()
    dx = float(np.max(np.abs(xg - xc) / (1 + np.abs(xc))))
    cross = {w: dict(signal=int(r.signal), iters=int(r.iter_count),
                     wall_s=walls[w]) for w, r in res.items()}
    cross["max_dx"] = dx
    print(f"  K={K} d={BLOCK_CELLS[cell]['instance']['d']} float64: card "
          f"signal "
          f"{cross['card']['signal']} iterations {cross['card']['iters']} "
          f"wall {walls['card']:.3f} s; CPU signal {cross['cpu']['signal']}"
          f" iterations {cross['cpu']['iters']} wall {walls['cpu']:.3f} s; "
          f"max |dx|/(1+|x|) {dx:.3e}", flush=True)
    if (cross["card"]["signal"], cross["card"]["iters"]) != (
            cross["cpu"]["signal"], cross["cpu"]["iters"]) or \
            cross["card"]["signal"] not in (1, 2) or not dx <= 1e-8:
        raise AssertionError(f"L-BFGS card against CPU: {cross}")
    cross["jax_card"] = hold_block_to_jax(cell, digests, res["card"])
    cross["jax_cpu"] = hold_block_to_jax(cell, digests, res["cpu"], "the CPU")
    out["cross_f64"] = cross

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as ex_out:
        block_lbfgs_and_ragged.main(device=device.type)
    out["example_s"] = time.perf_counter() - t0
    print("  examples/block_lbfgs_and_ragged.py: "
          + "; ".join(ex_out.getvalue().strip().splitlines())
          + f" ({out['example_s']:.2f} s)", flush=True)
    return out


def wide_fleet_phase(cfg, device, counters, sl, ll, lin, _sync):
    """Phase 26: WIDE_PORTFOLIO's fleet through ``solve_batch`` on the card
    (WIDE_TIMED timed solves, the counters reset before each; the first 3
    iterations of another solve profiled; peak allocation); one condensed
    direction of the fleet's first iterate through one batched
    ``reg_solve_kkt`` call and as B calls at B = 1 (the single-system path),
    each timed; the first WIDE_ROWS rows solved one at a time at B = 1 on
    the card and as one batch on the CPU, each held to the fleet's
    results."""
    from types import SimpleNamespace

    from pyipm_tpu_torch import solve_batch
    from pyipm_tpu_torch.config import matmul_precision
    from pyipm_tpu_torch.core import kkt as K
    from pyipm_tpu_torch.core.linesearch import take
    from pyipm_tpu_torch.core.solver import BatchSolver
    from pyipm_tpu_torch.models import applications as app
    from pyipm_tpu_torch.ops.condensed import _Condensed, _split
    Bn, Dn = WIDE_PORTFOLIO["B"], WIDE_PORTFOLIO["D"]
    t0 = time.perf_counter()
    data = app.portfolio_data(wide_arrays(), device=device)
    x0 = app.portfolio_x0(Bn, Dn, device=device)
    prob = app.make_portfolio_problem(Dn)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(device)
    walls = []
    for _ in range(WIDE_TIMED):
        res, wall = timed(lambda: solve_batch(prob, x0, cfg, params=data),
                          counters)
        walls.append(wall)
    peak = torch.cuda.max_memory_allocated(device)
    sig, its = res.signal.cpu().numpy(), res.iter_count.cpu().numpy()
    conv = torch.as_tensor(np.isin(sig, (1, 2)), device=device)
    hit = float(conv.float().mean())
    worst = structure_ok("portfolio", res.x[conv], take(data, conv),
                         res.fval[conv], prob)
    k3 = {str(k[1]): v for k, v in ll.LAUNCHES_BY_B.items()
          if v and k[0] == "panel_ldlt"}
    out = dict(instances=Bn, nvar=Dn, K=Dn + prob.neq, hit_rate=hit,
               mean_iters=float(its.mean()), max_iters=int(its.max()),
               signals={str(k): int(v) for k, v in
                        zip(*np.unique(sig, return_counts=True))},
               walls_s=walls, wall_s=float(np.median(walls)),
               flat_steps=_sync.COUNTS["flat_steps"],
               host_syncs=_sync.COUNTS["host_syncs"],
               launches={**sl.LAUNCHES, **ll.LAUNCHES}, kernel3_by_b=k3,
               launches_by_n=by_n(sl), max_memory_bytes=peak,
               structure_worst=worst, setup_s=setup_s,
               digests=digests(res.signal, res.iter_count, res.x))
    out["iters_per_s"] = float(its.sum()) / out["wall_s"]
    solver = BatchSolver(prob, cfg)
    st0 = solver.init_state(x0, data)
    _, busy, pwall, idle = busy_share(lambda: solver.run_budget(st0, 3,
                                                                data))
    out.update(profiled_iters=3, busy_ms=busy, profiled_wall_s=pwall,
               idle_share=idle)
    print(f"  B={Bn} portfolios of D={Dn} (K={out['K']}), float32: hit "
          f"rate {hit:.4f}, mean {out['mean_iters']:.3f}, max "
          f"{out['max_iters']} iterations, signals {out['signals']}; walls "
          f"{[round(w, 4) for w in walls]} s (median {out['wall_s']:.4f} s,"
          f" {out['iters_per_s']:.1f} iters/s); flat steps "
          f"{out['flat_steps']}, host syncs {out['host_syncs']} a solve; "
          f"kernel 3 launches by B {k3}, launches {out['launches']}; peak "
          f"allocation {peak} B; structural checks worst {worst:.3e}; "
          f"first 3 iterations profiled: device busy {busy:.1f} ms of "
          f"{pwall:.3f} s (idle {100 * idle:.1f}%); data made in "
          f"{setup_s:.2f} s; digests {out['digests']}", flush=True)
    if not np.all(np.isfinite(res.x.cpu().numpy())):
        raise AssertionError("wide portfolios: non-finite solution")
    if worst > 0:
        raise AssertionError(f"wide portfolios: structural check fails by "
                             f"{worst}")
    at1 = torch.as_tensor(sig == 1, device=device)
    if not bool((res.kkt[at1] <= cfg.Ktol).all()):
        raise AssertionError("wide portfolios: a Ktol-converged instance "
                             "has KKT > Ktol")
    if not k3.get(str(Bn)):
        raise AssertionError(f"kernel 3 was not launched at B = {Bn}: {k3}")
    out["jax"] = hold_to_jax("wide_portfolio", *(
        t[:WIDE_JAX_ROWS] for t in (res.signal, res.iter_count, res.fval,
                                    res.x)))
    if hit < 0.99:
        # f32 at this size: record, then the same fleet in f64
        cfg64 = cfg.replace(float_dtype="float64")
        d64 = retype(data, (t.double() for t in data))
        r64, w64 = timed(lambda: solve_batch(prob, x0.double(), cfg64,
                                             params=d64), counters)
        s64 = r64.signal.cpu().numpy()
        out["float64"] = dict(
            hit_rate=float(np.mean(np.isin(s64, (1, 2)))),
            mean_iters=float(r64.iter_count.float().mean()),
            max_iters=int(r64.iter_count.max()), wall_s=w64,
            signals={str(k): int(v) for k, v in
                     zip(*np.unique(s64, return_counts=True))})
        print(f"  again in float64: {out['float64']}", flush=True)
        del r64, d64

    # one condensed direction of the first iterate, batched and one by one
    cond = _Condensed(prob, st0.x, st0.s, st0.lda, data)
    rhs = cond.rhs(*_split(prob, -K.grad(prob, st0.x, st0.s, st0.lda,
                                        st0.mu, data)))
    kw = dict(nvar=Dn, neq=prob.neq, nineq=0, eps=cfg.eps,
              reg_coef=cfg.reg_coef, eta=cfg.eta, beta=cfg.beta,
              delta0=cfg.delta0, max_retries=cfg.max_reg_retries,
              want_solver=True, block=cfg.ldlt_block)

    def batched():
        return lin.reg_solve_kkt(cond.Kc, rhs, st0.delta, st0.mu, **kw)[:3]

    def one_by_one(n=Bn):
        outs = [lin.reg_solve_kkt(cond.Kc[i:i + 1], rhs[i:i + 1],
                                  st0.delta[i:i + 1], st0.mu[i:i + 1],
                                  **kw)[:3] for i in range(n)]
        return [torch.cat(o) for o in zip(*outs)]

    direction = {}
    with matmul_precision(cfg.matmul_precision):
        batched()                                              # warm-ups
        one_by_one(4)
        for name, fn in (("batched", batched), ("one_by_one", one_by_one)):
            r, wall = timed(fn, counters)
            direction[name] = dict(
                wall_s=wall, host_syncs=_sync.COUNTS["host_syncs"],
                launches=dict(ll.LAUNCHES),
                kernel3_by_b={str(k[1]): v for k, v in
                              ll.LAUNCHES_BY_B.items() if v}, out=r)
    rb, r1 = direction["batched"].pop("out"), direction["one_by_one"].pop(
        "out")
    direction.update(
        dz_max_rel_diff=float(rel_norm(rb[0], r1[0])),
        retries_equal=int((rb[2] == r1[2]).sum()),
        delta_new_equal=int((rb[1] == r1[1]).sum()))
    print(f"  one direction, (B, K) = ({Bn}, {out['K']}): batched "
          f"{direction['batched']}; as {Bn} calls at B = 1 "
          f"{direction['one_by_one']}; dz relative difference "
          f"{direction['dz_max_rel_diff']:.3e}, retries equal "
          f"{direction['retries_equal']}/{Bn}, delta_new equal "
          f"{direction['delta_new_equal']}/{Bn}", flush=True)
    if not bool(torch.isfinite(rb[0]).all()):
        raise AssertionError("the batched direction is not finite")
    out["one_direction"] = direction
    del cond, rhs, rb, r1, st0

    # the first rows one at a time at B = 1 on the card (the single-system
    # path), and as one batch on the CPU (the batched body, plain panel)
    rows = range(WIDE_ROWS)
    fields = ("signal", "iter_count", "x", "fval")
    mine = SimpleNamespace(**{f: getattr(res, f)[:WIDE_ROWS] for f in fields})
    t0 = time.perf_counter()
    ones = [solve_batch(prob, x0[i:i + 1], cfg,
                        params=take(data, torch.tensor([i], device=device)))
            for i in rows]
    one_wall = time.perf_counter() - t0
    ref1 = SimpleNamespace(**{f: torch.cat([getattr(o, f) for o in ones])
                              .cpu() for f in fields})
    out["rows_b1_card"] = card_against_cpu(
        "portfolio", mine, ref1, one_wall, against="B = 1 on the card")
    t0 = time.perf_counter()
    ref = solve_batch(prob, x0[:WIDE_ROWS].cpu(), cfg, params=retype(
        data, (t[:WIDE_ROWS].cpu() for t in data)))
    out["rows_cpu"] = card_against_cpu("portfolio", mine, ref,
                                       time.perf_counter() - t0)
    del res, data, ones, ref
    return out


# ----------------------------------------------------------------------
# phase 27: the package's default float64 on the card at full size
# kernels 1-5 timed in float64 at the shapes of phase 27's paths (kernel 1
# at the fleet's n = 16 and 36 and the wide branch's portfolio and SVM
# sizes, kernel 2 at the fleet's, MPC's and SVM's; kernel 3 alone and on
# the wide fleet's batch; kernels 4-5 at npad 5120)
F64_FACTOR_SHAPES = ((B, 16), (B, 36), (PATH_B, 65), (PATH_B, 97))
F64_SOLVE_SHAPES = ((B, 16), (B, 36), (PATH_B, 40), (PATH_B, 97))
# the float64 branches a solve of phase 27 must launch: kernels 1-2 at
# these n and at one n of the wide branch (64 < n <= 128) at least
F64_NEED_N = dict(factor=(16, 36), solve=(16, 36, 40))
# the profiler traces a phase-27 kernel row takes at most (device_ms): a
# trace that drops a launch's events is taken again
F64_TRACES = 3


def f64_arrays_check(cell, arrays, entry):
    """Print the drawn instances' sha256s beside the manifest's: (equal,
    digests).  A difference is printed, not raised: a sampler whose products
    run through numpy's ``einsum`` or BLAS (``sample_qp_arrays``,
    ``sample_portfolio_arrays``, ``sample_svm_arrays``,
    ``sample_dense_arrays``, ``box_qp_data``) may round them differently
    on another host's CPU."""
    got = input_digests(arrays)
    ref = entry.get("inputs", {})
    differ = sorted(k for k in set(got) | set(ref) if got.get(k) != ref.get(k))
    short = {k: (got.get(k, "-")[:16], ref.get(k, "-")[:16])
             for k in sorted(got)}
    print(f"  {cell} inputs (sha256 here, manifest): {short}; "
          + (f"differ at {differ} (another host's rounding of the "
             f"sampler's products; the hold runs at its bounds all the "
             f"same)" if differ else "all equal"), flush=True)
    return not differ, got


def f64_cell(cell, res, wall, arrays, entry, profile, sl, ll, _sync,
             rows=None):
    """The record of one timed float64 solve of ``cell``: wall, hit rate,
    iterations, host syncs, launches by kernel, n and B (the counters reset
    just before it), the busy share of ``profile`` (3 inner iterations of
    another solve), the input digests, and the hold to the JAX package.
    Raises unless every tensor of the result is float64."""
    bad = [k for k in ("x", "fval", "kkt", "lda")
           if getattr(res, k).dtype != torch.float64]
    if bad:
        raise AssertionError(f"{cell}: {bad} of the solve are not float64")
    sig = res.signal.reshape(-1).cpu().numpy()
    its = res.iter_count.reshape(-1).cpu().numpy()
    rec = dict(instances=int(sig.size),
               hit_rate=float(np.mean(np.isin(sig, (1, 2)))),
               mean_iters=float(its.mean()), max_iters=int(its.max()),
               signals={str(k): int(v) for k, v in
                        zip(*np.unique(sig, return_counts=True))},
               wall_s=wall, iters_per_s=float(its.sum()) / wall,
               host_syncs=_sync.COUNTS["host_syncs"],
               flat_steps=_sync.COUNTS["flat_steps"],
               launches={**sl.LAUNCHES, **ll.LAUNCHES},
               launches_by_n=by_n(sl),
               kernel3_by_b={str(k[1]): v for k, v in
                             ll.LAUNCHES_BY_B.items() if v})
    if not bool(torch.isfinite(res.x).all()):
        raise AssertionError(f"{cell}: non-finite solution")
    _, busy, pwall, idle = busy_share(profile)
    rec.update(profiled_iters=3, busy_ms=busy, profiled_wall_s=pwall,
               idle_share=idle)
    rec["inputs_equal"], _ = f64_arrays_check(cell, arrays, entry)
    print(f"  {cell}: {sig.size} instances, hit rate {rec['hit_rate']:.4f}, "
          f"mean {rec['mean_iters']:.4f}, max {rec['max_iters']} iterations, "
          f"signals {rec['signals']}; wall {wall:.4f} s "
          f"({rec['iters_per_s']:.1f} iters/s), host syncs "
          f"{rec['host_syncs']}, flat steps {rec['flat_steps']}; launches "
          f"{rec['launches']}, by n {rec['launches_by_n']}, kernel 3 by B "
          f"{rec['kernel3_by_b']}; first 3 iterations profiled: device busy "
          f"{busy:.1f} ms of {pwall:.3f} s (idle {100 * idle:.1f}%)",
          flush=True)
    take_rows = (lambda t: t) if rows is None else (lambda t: t[:rows])
    rec["jax"] = hold_to_jax(cell, *(take_rows(t) for t in (
        res.signal, res.iter_count, res.fval, res.x)))
    return rec


def f64_kernel_rows(sl, ll, lin, device):
    """Kernels 1-5 in float64 at the shapes of phase 27's paths against
    their plain versions: ms (CUDA events), device ms per launch, the plain
    version's ms, the library call's where one exists
    (``torch.linalg.ldl_solve`` for kernel 2, ``solve_triangular`` for the
    sweeps; one call, timed after a warm-up at B = 1), the max abs
    difference from the plain version and the bound (8-byte words,
    F64_FLOPS)."""
    f64 = torch.float64
    gen = torch.Generator().manual_seed(SEED + 27)
    rows = {}

    def once_ms(fn, warm, what):
        try:
            warm()
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            return e0.elapsed_time(e1)
        except RuntimeError as exc:
            print(f"  {what} unavailable: {exc}", flush=True)
            return None

    for Bn, n in F64_FACTOR_SHAPES:
        t_row = time.perf_counter()
        A = rand_sym(gen, Bn, n, f64, device)
        L, d = sl.ldlt_factor_small(A)
        Lr, dr = sl.ldlt_factor_small_ref(A)
        rows[f"ldlt_factor_small_f64_{Bn}x{n}"] = dict(
            max_abs_err=max(float((L - Lr).abs().max()),
                            float((d - dr).abs().max())),
            ms=cuda_ms(lambda: sl.ldlt_factor_small(A), REPS),
            device_ms=device_ms(lambda: sl.ldlt_factor_small(A),
                                ("ldlt_factor_kernel",), traces=F64_TRACES),
            plain_ms=cuda_ms(lambda: sl.ldlt_factor_small_ref(A), 3),
            library_ms=None, bound=factor_bound(Bn, n, f64), shape=[Bn, n],
            row_s=time.perf_counter() - t_row)
    for Bn, n in F64_SOLVE_SHAPES:
        t_row = time.perf_counter()
        A = rand_sym(gen, Bn, n, f64, device)
        b = torch.randn(Bn, n, generator=gen, dtype=f64).to(device)
        L, d = sl.ldlt_factor_small(A)
        LD = torch.tril(L, -1) + torch.diag_embed(d)
        piv = torch.arange(1, n + 1, dtype=torch.int32,
                           device=device).expand(Bn, n).contiguous()
        rows[f"ldlt_solve_small_f64_{Bn}x{n}"] = dict(
            max_abs_err=float((sl.ldlt_solve_small(L, d, b)
                               - sl.ldlt_solve_small_ref(L, d, b))
                              .abs().max()),
            ms=cuda_ms(lambda: sl.ldlt_solve_small(L, d, b), REPS),
            device_ms=device_ms(lambda: sl.ldlt_solve_small(L, d, b),
                                ("ldlt_solve_kernel",), traces=F64_TRACES),
            plain_ms=cuda_ms(lambda: sl.ldlt_solve_small_ref(L, d, b), 3),
            library_ms=once_ms(
                lambda: torch.linalg.ldl_solve(LD, piv, b[..., None]),
                lambda: torch.linalg.ldl_solve(LD[:1], piv[:1],
                                               b[:1, :, None]),
                "torch.linalg.ldl_solve"),
            bound=solve_bound(Bn, n, f64), shape=[Bn, n],
            row_s=time.perf_counter() - t_row)
        del A, L, d, LD, piv, b
    P1 = rand_sym(gen, 1, 128, f64, device)[0].contiguous()
    Pb = rand_sym(gen, WIDE_PORTFOLIO["B"], 128, f64, device)
    for name, P in (("panel_ldlt_f64", P1),
                    (f"panel_ldlt_batched_{WIDE_PORTFOLIO['B']}_f64", Pb)):
        t_row = time.perf_counter()
        L, d = ll.panel_ldlt(P)
        Lr, dr = ll.panel_ldlt_ref(P)
        rows[name] = dict(
            max_abs_err=max(float((L - Lr).abs().max()),
                            float((d - dr).abs().max())),
            ms=cuda_ms(lambda: ll.panel_ldlt(P), REPS),
            device_ms=device_ms(lambda: ll.panel_ldlt(P),
                                ("panel_ldlt_kernel",), traces=F64_TRACES),
            plain_ms=cuda_ms(lambda: ll.panel_ldlt_ref(P), 3),
            library_ms=None,
            bound=factor_bound(P.shape[0] if P.dim() == 3 else 1, 128, f64),
            shape=list(P.shape), row_s=time.perf_counter() - t_row)
    del P1, Pb
    t_row = time.perf_counter()
    H, _ = kkt_matrix_bench(4096, 256, f64, device)
    Hs = lin.ruiz_scale(H[None])[0][0]
    Lp, _, invp = lin.ldlt_factor_panels(Hs)
    Lb, _, invb = lin.ldlt_factor_blocks(Hs, group=8)
    z = torch.randn(Lp.shape[0], generator=gen, dtype=f64).to(device)
    for name, fn, Lf, inv, kernels in (
            ("bwd_sweep_panels_f64", ll.bwd_sweep_panels, Lp, invp,
             ("sweep_panels_kernel",)),
            ("bwd_sweep_blocks_f64", ll.bwd_sweep_blocks, Lb, invb,
             ("sweep_blocks_kernel",))):
        Lt = Lf.mT
        rows[name] = dict(
            max_abs_err=float((fn(Lf, z, inv) - ll.bwd_sweep_ref(Lf, z, inv))
                              .abs().max()),
            ms=cuda_ms(lambda: fn(Lf, z, inv), REPS),
            device_ms=device_ms(lambda: fn(Lf, z, inv), kernels,
                                traces=F64_TRACES),
            plain_ms=cuda_ms(lambda: ll.bwd_sweep_ref(Lf, z, inv), 10),
            library_ms=cuda_ms(lambda: torch.linalg.solve_triangular(
                Lt, z[:, None], upper=True, unitriangular=True), 10),
            bound=sweep_bound(Hs.shape[0], inv.shape[-1], f64),
            shape=[Lf.shape[0], inv.shape[-1]],
            row_s=time.perf_counter() - t_row)
        t_row = time.perf_counter()
    del H, Hs, Lp, invp, Lb, invb
    for name, r in rows.items():
        dev = r["device_ms"]
        print(f"  f64 {name} at {r['shape']}: {r['ms']:.4f} ms per call "
              f"(CUDA events, median), device {dev[0]:.4f} ms per launch in "
              f"{dev[2]} launches per call (by {dev[1]}; "
              f"{dev[0] / r['bound'][0]:.2f}x the bound), plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
              f"{r['bound'][0]:.5f} ms by {r['bound'][1]}; max |kernel - "
              f"plain| {r['max_abs_err']:.3e}; {r['row_s']:.1f} s", flush=True)
    return rows


def f64_phase(counters, sl, ll, lin, _sync, device):
    """Phase 27: the package's default float_dtype (an ``IPMConfig()``
    left at float64) on the card at full size, each path through the entry
    point of its float32 twin: phase 4's and phase 10's fleets
    (``solve_batch``), phase 8's dense NLP with 'condensed' and 'ldlt'
    (``solve``), phase 16's buckets (``solve_fleet``) and phase 26's wide
    fleet (``solve_batch``, one timed solve, its peak allocation); each on
    float64 instances drawn on the host (``twin_arrays``), the counters
    reset just before its timed solve, held to its F64_CELLS reference by
    ``hold_to_jax`` (every signal and iteration count equal, x and f within
    JAX_F64_TOL).  Raises if a solve's tensors are not float64, if a
    kernel's float64 branch was not launched inside a solve (kernels 1-2 at
    F64_NEED_N and in the wide branch, kernel 3 on one panel and on a
    batch, kernels 4 and 5) or if a hold fails; then times kernels 1-5 in
    float64 (``f64_kernel_rows``)."""
    import gc

    from pyipm_tpu_torch import IPMConfig, solve, solve_batch, solve_fleet
    from pyipm_tpu_torch.config import matmul_precision
    from pyipm_tpu_torch.core.linesearch import take
    from pyipm_tpu_torch.core.solver import BatchSolver
    from pyipm_tpu_torch.models import applications as app
    from pyipm_tpu_torch.models.random_nlp import (
        dense_nlp_data, make_dense_nlp_problem, make_qp_problem, qp_data,
    )
    t_phase = time.perf_counter()
    cfg = IPMConfig(verbosity=0, Ktol=1e-4)
    if cfg.float_dtype != "float64":
        raise AssertionError(f"IPMConfig() defaults to {cfg.float_dtype}")
    gc.collect()
    torch.cuda.empty_cache()
    out = {}

    def profile(prob, x0, data, c):
        solver = BatchSolver(prob, c)
        st0 = solver.init_state(x0, data)
        return lambda: solver.run_budget(st0, 3, data)

    # phases 4 and 10: the 10,000-QP fleet, 'adaptive' and 'mehrotra'
    problem = make_qp_problem(D, NLIN)
    for mu in ("adaptive", "mehrotra"):
        t_cell = time.perf_counter()
        cell = f"qp_{mu}_f64"
        entry = jax_reference(cell)[0]
        arrays = twin_arrays(cell)
        data = qp_data(arrays, device=device)
        x0 = torch.as_tensor(qp_x0(), device=device).double()
        c = cfg.replace(mu_strategy=mu)
        solve_batch(problem, x0[:N_CROSS], c, params=take(
            data, torch.arange(N_CROSS, device=device)))         # warm-up
        res, wall = timed(lambda: solve_batch(problem, x0, c, params=data),
                          counters)
        out[cell] = f64_cell(cell, res, wall, arrays, entry,
                             profile(problem, x0, data, c), sl, ll, _sync)
        out[cell]["cell_s"] = time.perf_counter() - t_cell
        del res, data
    # phase 8: the dense NLP, 'condensed' and 'ldlt'
    dproblem = make_dense_nlp_problem(DENSE_D, DENSE_M)
    for solver in ("condensed", "ldlt"):
        t_cell = time.perf_counter()
        cell = f"dense_{solver}_f64"
        entry = jax_reference(cell)[0]
        arrays = twin_arrays(cell)
        ddata = dense_nlp_data(arrays, device=device)
        dcfg = cfg.replace(linear_solver=solver)
        rec, res = dense_path(solve, dcfg, dproblem, ddata, device,
                              (sl.LAUNCHES, sl.LAUNCHES_BY_N, ll.LAUNCHES,
                               ll.LAUNCHES_BY_B), _sync)
        rec.update(launches_by_n=by_n(sl), kernel3_by_b={
            str(k[1]): v for k, v in ll.LAUNCHES_BY_B.items() if v})
        p1 = type(ddata)(*(t[None] for t in ddata))
        x1 = torch.full((1, DENSE_D), DENSE_X0, dtype=torch.float64,
                        device=device)
        _, busy, pwall, idle = busy_share(profile(dproblem, x1, p1, dcfg))
        rec.update(busy_ms=busy, profiled_wall_s=pwall, idle_share=idle)
        rec["inputs_equal"], _ = f64_arrays_check(cell, arrays, entry)
        if res.x.dtype != torch.float64:
            raise AssertionError(f"{cell}: x is {res.x.dtype}")
        print(f"  {cell}: signal {rec['signal']} iterations {rec['iters']} "
              f"max KKT {rec['kkt_max']:.3e} wall {rec['wall_s']:.4f} s host "
              f"syncs {rec['host_syncs']} flat steps {rec['flat_steps']} "
              f"launches {rec['launches']}, kernel 3 by B "
              f"{rec['kernel3_by_b']}; max_memory_allocated "
              f"{rec['max_memory_bytes']} B; first 3 iterations profiled: "
              f"device busy {busy:.1f} ms of {pwall:.3f} s (idle "
              f"{100 * idle:.1f}%)", flush=True)
        if rec["signal"] not in (1, 2):
            raise AssertionError(f"{cell}: signal {rec['signal']}")
        out[cell] = rec
        rec["cell_s"] = time.perf_counter() - t_cell
        del ddata, p1, res
    # phase 16: each bucket alone through solve_fleet
    t_cell = time.perf_counter()
    for name, (prob, data, x0b) in mixed_buckets(device, np.float64).items():
        cell = f"mixed_{name}_f64"
        entry = jax_reference(cell)[0]
        Bn = x0b.shape[0]
        params = [take(data, i) for i in range(Bn)]
        solve_fleet([prob] * 64, list(x0b[:64]), cfg, params=params[:64],
                    device=device)                             # warm-up
        res, wall = timed(lambda: stack(solve_fleet(
            [prob] * Bn, list(x0b), cfg, params=params, device=device)),
            counters)
        out[cell] = f64_cell(cell, res, wall, twin_arrays(cell), entry,
                             profile(prob, x0b, data, cfg), sl, ll, _sync)
        out[cell]["cell_s"] = time.perf_counter() - t_cell
        t_cell = time.perf_counter()
        del res, params
    # phase 26: the wide portfolio fleet, one timed solve
    t_cell = time.perf_counter()
    cell = "wide_portfolio_f64"
    entry = jax_reference(cell)[0]
    Bn, Dn = WIDE_PORTFOLIO["B"], WIDE_PORTFOLIO["D"]
    arrays = twin_arrays(cell)
    data = app.portfolio_data(arrays, device=device)
    x0 = app.portfolio_x0(Bn, Dn, np.float64, device=device)
    prob = app.make_portfolio_problem(Dn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    res, wall = timed(lambda: solve_batch(prob, x0, cfg, params=data),
                      counters)
    peak = torch.cuda.max_memory_allocated(device)
    out[cell] = f64_cell(cell, res, wall, arrays, entry,
                         profile(prob, x0, data, cfg), sl, ll, _sync,
                         rows=WIDE_JAX_ROWS)
    out[cell].update(max_memory_bytes=peak,
                     cell_s=time.perf_counter() - t_cell)
    print(f"  {cell}: peak allocation {peak} B", flush=True)
    del res, data, arrays
    _wide_draw.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()

    # every float64 branch launched inside a solve
    seen = {}
    for rec in out.values():
        for k, by in rec["launches_by_n"].items():
            seen.setdefault(k, set()).update(int(n) for n in by)
    b3 = {int(b) for rec in out.values() for b in rec["kernel3_by_b"]}
    missing = [f"kernel {1 if k == 'factor' else 2} at n = {n}"
               for k, ns in F64_NEED_N.items() for n in ns
               if n not in seen.get(k, ())]
    missing += [f"kernel {1 if k == 'factor' else 2} in the wide branch"
                for k in ("factor", "solve")
                if not any(64 < n <= 128 for n in seen.get(k, ()))]
    missing += [what for what, ok in (
        ("kernel 3 on one panel", 1 in b3),
        ("kernel 3 on a batch", any(b > 1 for b in b3)),
        ("kernel 4", out["dense_ldlt_f64"]["launches"]["bwd_sweep_panels"]),
        ("kernel 5", out["dense_condensed_f64"]["launches"][
            "bwd_sweep_blocks"])) if not ok]
    print(f"  float64 launches inside the solves: kernel 1 at n = "
          f"{sorted(seen.get('factor', ()))}, kernel 2 at n = "
          f"{sorted(seen.get('solve', ()))}, kernel 3 at B = {sorted(b3)}, "
          f"kernel 4 {out['dense_ldlt_f64']['launches']['bwd_sweep_panels']}"
          f", kernel 5 "
          f"{out['dense_condensed_f64']['launches']['bwd_sweep_blocks']}",
          flush=True)
    if missing:
        raise AssertionError(f"float64 branches not launched inside a solve:"
                             f" {missing}")
    t_rows = time.perf_counter()
    with matmul_precision(cfg.matmul_precision):
        out["kernels"] = f64_kernel_rows(sl, ll, lin, device)
    out["phase_s"] = time.perf_counter() - t_phase
    by_cell = {k: round(v["cell_s"], 1) for k, v in out.items()
               if isinstance(v, dict) and "cell_s" in v}
    print(f"  phase 27: {out['phase_s']:.1f} s; seconds by cell (its draw, "
          f"warm-up, solve, profile and hold) {by_cell}, the kernel rows "
          f"{time.perf_counter() - t_rows:.1f}", flush=True)
    return out


def f64_record_rows(row, f64):
    """The kernels line's float64 rows (``row(...)`` of main), each with
    its launches inside phase 27's solve of the path it was timed for."""
    small = "pyipm_tpu_torch/csrc/small_ldlt.cu"
    panel = "pyipm_tpu_torch/csrc/panel_ldlt.cu"
    cells = {k: v for k, v in f64.items() if isinstance(v, dict)
             and "launches" in v}

    def at_n(cell, kernel, n):
        return cells[cell]["launches_by_n"].get(kernel, {}).get(str(n), 0)

    # the cell whose solve gives each shape's launches
    of_n = {16: "qp_adaptive_f64", 36: "qp_adaptive_f64",
            40: "mixed_mpc_f64", 65: "mixed_portfolio_f64",
            97: "mixed_svm_f64"}
    out = []
    for name, r in f64["kernels"].items():
        if name.startswith("ldlt_"):
            kernel = "factor" if "factor" in name else "solve"
            n = r["shape"][1]
            launches = at_n(of_n[n], kernel, n)
            src, rep = small, ("pyipm_tpu/ops/pallas_ldlt.py:49"
                               if kernel == "factor" else
                               "pyipm_tpu/ops/pallas_ldlt.py:92")
        elif name == "panel_ldlt_f64":
            launches = sum(cells[c]["kernel3_by_b"].get("1", 0)
                           for c in ("dense_condensed_f64", "dense_ldlt_f64"))
            src, rep = panel, "pyipm_tpu/ops/pallas_ldlt.py:198"
        elif name.startswith("panel_ldlt_batched"):
            launches = cells["wide_portfolio_f64"]["kernel3_by_b"].get(
                str(WIDE_PORTFOLIO["B"]), 0)
            src, rep = panel, "pyipm_tpu/ops/pallas_ldlt.py:198"
        elif name == "bwd_sweep_panels_f64":
            launches = cells["dense_ldlt_f64"]["launches"]["bwd_sweep_panels"]
            src = "pyipm_tpu_torch/csrc/bwd_sweep_panels.cu"
            rep = "pyipm_tpu/ops/pallas_ldlt.py:523"
        else:
            launches = cells["dense_condensed_f64"]["launches"][
                "bwd_sweep_blocks"]
            src = "pyipm_tpu_torch/csrc/bwd_sweep_blocks.cu"
            rep = "pyipm_tpu/ops/pallas_ldlt.py:386"
        out.append(row(name, rep, src, launches, r, r["shape"]))
    return out


T_START = time.perf_counter()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        return 1
    from pyipm_tpu_torch import IPMConfig, _sync, solve, solve_batch
    from pyipm_tpu_torch.config import matmul_precision
    from pyipm_tpu_torch.models.random_nlp import (
        make_dense_nlp_problem, sample_dense_nlp,
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
    sl.LAUNCHES_BY_N.clear()          # the checks' own launches are no run's

    phase("4 slice A: 10,000-QP float32 fleet on cuda:0")
    cfg = IPMConfig(float_dtype="float32", verbosity=0, Ktol=1e-4)
    problem, data, x0 = qp_fleet(cfg, device)
    reset(sl.LAUNCHES, sl.LAUNCHES_BY_N, ll.LAUNCHES, _sync.COUNTS)
    t0 = time.perf_counter()
    res = solve_batch(problem, x0, cfg, params=data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(sl.LAUNCHES)
    launches_n = by_n(sl)
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
                 host_syncs=stats["host_syncs"], launches_by_n=launches_n,
                 digests=digests(res.signal, res.iter_count, res.x))
    print(f"  digests (sha256 of the bytes): {fleet['digests']}", flush=True)
    # phase 4's per-instance result, what phases 13-15 and 17 are held to
    lockstep = dict(fleet, sig=sig, its=its, x=res.x.cpu().numpy())
    if tuple(res.x.shape) != (B, D) or not bool(torch.isfinite(res.x).all()):
        raise AssertionError("fleet solution is not a finite (B, D) array")
    if hit < 0.99:
        raise AssertionError(f"hit rate {hit} < 0.99")
    conv = torch.as_tensor(np.isin(sig, (1,)), device=device)
    if not bool((res.kkt[conv] <= cfg.Ktol).all()):
        raise AssertionError("a Ktol-converged instance has KKT > Ktol")
    require_launched(launches, "fleet")
    fleet["jax"] = hold_to_jax("qp_adaptive", res.signal, res.iter_count,
                               res.fval, res.x)

    phase(f"5 plain path on CPU, first {N_CROSS} instances")
    data_cpu = type(data)(*(t[:N_CROSS].cpu() for t in data))
    res_cpu = solve_batch(problem, x0[:N_CROSS].cpu(), cfg, params=data_cpu)
    cross_check(sig, its, res.x.cpu().numpy(), res_cpu, "adaptive", 58)
    del res, res_cpu

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
        r, _ = dense_path(solve, dcfg, dproblem, ddata, device,
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

    phase("10 Mehrotra predictor-corrector on phase 4's fleet, cuda:0")
    mcfg = cfg.replace(mu_strategy="mehrotra")
    solve_batch(problem, torch.zeros((B, D), device=device), mcfg,
                params=data)                                     # warm-up
    torch.cuda.synchronize()
    reset(sl.LAUNCHES, ll.LAUNCHES, _sync.COUNTS)
    t0 = time.perf_counter()
    mres = solve_batch(problem, x0, mcfg, params=data)
    torch.cuda.synchronize()
    mwall = time.perf_counter() - t0
    mlaunches = dict(sl.LAUNCHES)
    mstats = dict(_sync.COUNTS)
    msig = mres.signal.cpu().numpy()
    mits = mres.iter_count.cpu().numpy()
    mhit = float(np.mean(np.isin(msig, (1, 2))))
    mtotal = int(mits.sum())
    print(f"  hit_rate={mhit:.4f} mean_iters={mits.mean():.3f} (TPU-era "
          f"convergence figure of the JAX package, BENCH_r05 "
          f"mehrotra_mean_iters: {TPU_ERA_MEHROTRA_MEAN_ITERS}) "
          f"max_iters={int(mits.max())} total_iters={mtotal} "
          f"wall_s={mwall:.4f} iters_per_s={mtotal / mwall:.1f} "
          f"flat_steps={mstats['flat_steps']} "
          f"host_syncs={mstats['host_syncs']} "
          f"launches_factor={mlaunches['factor']} "
          f"launches_solve={mlaunches['solve']} per solve; adaptive (phase "
          f"4): mean_iters={fleet['mean_iters']:.3f} "
          f"wall_s={fleet['wall_s']:.4f} flat_steps={fleet['flat_steps']} "
          f"host_syncs={fleet['host_syncs']} launches {launches}",
          flush=True)
    if not bool(torch.isfinite(mres.x).all()):
        raise AssertionError("Mehrotra fleet solution is not finite")
    if mhit < 0.99:
        raise AssertionError(f"Mehrotra hit rate {mhit} < 0.99")
    require_launched(mlaunches, "Mehrotra fleet")
    mres_cpu = solve_batch(problem, x0[:N_CROSS].cpu(), mcfg,
                           params=data_cpu)
    mcross = cross_check(msig, mits, mres.x.cpu().numpy(), mres_cpu,
                         "mehrotra", N_CROSS)
    mehrotra = dict(hit_rate=mhit, mean_iters=float(mits.mean()),
                    max_iters=int(mits.max()), wall_s=mwall,
                    iters_per_s=mtotal / mwall,
                    flat_steps=mstats["flat_steps"],
                    host_syncs=mstats["host_syncs"], launches=mlaunches,
                    cpu_cross_check=mcross,
                    jax=hold_to_jax("qp_mehrotra", mres.signal,
                                    mres.iter_count, mres.fval, mres.x))
    del mres, mres_cpu

    phase(f"11 L-BFGS({LBFGS_MEM}) on the dense NLP D={LBFGS_D}, "
          f"M={LBFGS_M}, float64, cuda:0")
    # the configuration of tests/test_lbfgs_large.py:26-37; its instance
    # comes from jax.random.key(0), which cannot be drawn without JAX, so
    # the port's numpy sampler with seed LBFGS_SEED stands in for it
    lcfg = IPMConfig(**LBFGS_CFG, verbosity=0)
    lproblem = make_dense_nlp_problem(LBFGS_D, LBFGS_M)
    ldata = sample_dense_nlp(LBFGS_SEED, LBFGS_D, LBFGS_M, DENSE_H,
                             dtype="float64", device=device)
    lx0 = torch.zeros(LBFGS_D, dtype=torch.float64, device=device)
    solve(lproblem, lx0, lcfg, params=ldata)                    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset(sl.LAUNCHES, ll.LAUNCHES, _sync.COUNTS)
    t0 = time.perf_counter()
    lres = solve(lproblem, lx0, lcfg, params=ldata)
    torch.cuda.synchronize()
    lbfgs = dict(signal=int(lres.signal), iters=int(lres.iter_count),
                 kkt_max=float(lres.kkt.max()),
                 wall_s=time.perf_counter() - t0,
                 host_syncs=_sync.COUNTS["host_syncs"],
                 flat_steps=_sync.COUNTS["flat_steps"],
                 launches={**sl.LAUNCHES, **ll.LAUNCHES},
                 max_memory_bytes=torch.cuda.max_memory_allocated(device))
    print(f"  signal {lbfgs['signal']} iterations {lbfgs['iters']} max KKT "
          f"{lbfgs['kkt_max']:.3e} wall {lbfgs['wall_s']:.4f} s host syncs "
          f"{lbfgs['host_syncs']} flat steps {lbfgs['flat_steps']} launches "
          f"{lbfgs['launches']} max_memory_allocated "
          f"{lbfgs['max_memory_bytes']} B", flush=True)
    if lbfgs["signal"] != 1 or lbfgs["kkt_max"] > lcfg.Ktol:
        raise AssertionError(f"L-BFGS dense NLP: signal {lbfgs['signal']}, "
                             f"KKT {lbfgs['kkt_max']}")
    lbfgs["jax"] = hold_to_jax("dense_lbfgs", lres.signal, lres.iter_count,
                               lres.fval, lres.x)
    require_launched(dict(sl.LAUNCHES), "L-BFGS dense NLP")
    del ldata

    phase("12 the IPM facade and the CLI on cuda:0, problems 1-10")
    reset(sl.LAUNCHES, ll.LAUNCHES, _sync.COUNTS)
    facade = cli_runs()
    facade["launches"] = dict(sl.LAUNCHES)
    print(f"  {facade['runs']} runs converged (in-process runs "
          f"{facade['wall_s']:.2f} s, launches {facade['launches']})",
          flush=True)
    require_launched(facade["launches"], "CLI")

    counters = (sl.LAUNCHES, sl.LAUNCHES_BY_N, ll.LAUNCHES, _sync.COUNTS)
    phase(f"13 wave-compacted fleet (first_wave, wave = {WAVE_FIRST}, "
          f"{WAVE}; then {WAVE_SMALL}, {WAVE_SMALL}) on phase 4's fleet, "
          f"cuda:0")
    wave, wave_fn = wave_phase(problem, cfg, x0, data, lockstep, counters,
                               sl, ll, _sync, WAVE_FIRST, WAVE)
    wave["small_waves"], _ = wave_phase(problem, cfg, x0, data, lockstep,
                                        counters, sl, ll, _sync, WAVE_SMALL,
                                        WAVE_SMALL)

    phase(f"14 run_budget({BUDGET}), save_state, restore_state onto the "
          f"card, run: phase 4's fleet")
    budget = budget_phase(problem, cfg, x0, data, lockstep, counters, sl, ll,
                          _sync)

    phase("15 phase 4's fleet at niter 2, miter 3 (and 3, 5), then "
          "rescue_failures")
    rescue = rescue_phase(problem, cfg, x0, data, counters, sl, ll, _sync,
                          2, 3)
    # a budget that leaves half the fleet converged, which must not move
    rescue["niter3_miter5"] = rescue_phase(problem, cfg, x0, data, counters,
                                           sl, ll, _sync, 3, 5)

    phase("16 a mixed fleet through solve_fleet, float32, cuda:0")
    mixed = mixed_fleet_phase(cfg, device, counters, sl, ll, _sync)

    phase("17 observability: profile_solve, trace(), trace_metrics, "
          "--profile")
    observe = observability_phase(problem, cfg, x0, data, wave_fn, lockstep,
                                  counters, sl, _sync)
    del data

    phase("18 kernels 1-2 against their plain versions at every size a run "
          "launched them at that phase 3 did not check")
    reset(sl.LAUNCHES_BY_N)
    held_late = hold_seen_sizes(sl, device)
    print(f"  phases 4-17 launched kernel 1 at n = "
          f"{sorted(n for k, n in SEEN if k == 'factor')}, kernel 2 at n = "
          f"{sorted(n for k, n in SEEN if k == 'solve')}; held here at n = "
          f"{held_late} (B = {PATH_B}), the rest in phase 3", flush=True)

    counters = (sl.LAUNCHES, sl.LAUNCHES_BY_N, ll.LAUNCHES,
                ll.LAUNCHES_BY_B, _sync.COUNTS)
    from pyipm_tpu_torch.parallel import schur as S
    with matmul_precision(cfg.matmul_precision):
        phase("19 batched_reg_factor at the Schur shapes, kernels 1 and 3 "
              "against their plain versions")
        schur_factor, schur_kernels = schur_factor_phase(lin, sl, ll, cfg,
                                                         device)
    phase(f"21 a million variables as K={WEAK['K']} blocks of "
          f"d={WEAK['d']}, mc={WEAK['mc']}, no refinement, float32")
    schur = {"weak": separable_phase(S, "schur_weak", counters, sl, ll,
                                     _sync, device, need_k1=True)}
    phase(f"22 large blocks (K={LARGE['K']}, d={LARGE['d']}, "
          f"mc={LARGE['mc']}), float32: the batched kernel 3")
    schur["large"] = separable_phase(S, "schur_large", counters, sl, ll,
                                     _sync, device, need_k3=True)
    phase("23 general block NLPs: resource allocation, nonlinear and "
          "linear coupling, ragged, pause and resume")
    schur["general"] = general_phase(S, counters, sl, ll, _sync, device)
    reset(sl.LAUNCHES_BY_N)
    held_schur = hold_seen_sizes(sl, device)
    print(f"  kernel 1 held to its plain version at the new sizes n = "
          f"{held_schur} (B = {PATH_B})", flush=True)
    phase("24 two ranks on the card (launch --spawn 2, gloo)")
    schur["ranks"] = ranks_phase(S, device)
    phase(f"25 the per-block L-BFGS mode: {LBFGS_BLOCK['K']} blocks of "
          f"d={LBFGS_BLOCK['d']}, mc={LBFGS_BLOCK['p']}, float32")
    schur["lbfgs_block"] = lbfgs_block_phase(S, counters, sl, ll, _sync,
                                             device)
    phase(f"26 {WIDE_PORTFOLIO['B']} portfolios of {WIDE_PORTFOLIO['D']} "
          f"assets, float32: the batched K > 128 path")
    wide = wide_fleet_phase(cfg, device, counters, sl, ll, lin, _sync)
    phase("27 the package's default float64 at full size: phases 4, 10, 8, "
          "16 and 26 held to the JAX package")
    f64 = f64_phase(counters, sl, ll, lin, _sync, device)
    reset(sl.LAUNCHES_BY_N)
    held_f64 = hold_seen_sizes(sl, device)
    print(f"  kernels 1-2 held to their plain versions at the new sizes n = "
          f"{held_f64} (B = {PATH_B})", flush=True)

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
    tw = times[WIDE_ROW_SHAPE[1]]
    small = "pyipm_tpu_torch/csrc/small_ldlt.cu"
    # the wide branch's launches on phase 16's main path: the one call
    # with every bucket
    wide_launches = sum(
        c for n, c in mixed["all_buckets"]["launches_by_n"].get(
            "factor", {}).items() if int(n) > 64)
    wide_solve_launches = sum(
        c for n, c in mixed["all_buckets"]["launches_by_n"].get(
            "solve", {}).items() if int(n) > 64)
    if wide_launches == 0 or wide_solve_launches == 0:
        raise AssertionError("the mixed fleet never launched kernel 1's "
                             "or kernel 2's wide branch")
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
        row("ldlt_factor_small_wide", "pyipm_tpu/ops/pallas_ldlt.py:49",
            small, wide_launches,
            dict(max_abs_err=err["factor_wide"], ms=tw["factor"],
                 device_ms=tw["factor_device"], plain_ms=tw["factor_plain"],
                 bound=tw["factor_bound"], library_ms=None),
            list(WIDE_ROW_SHAPE)),
        row("ldlt_solve_small_wide", "pyipm_tpu/ops/pallas_ldlt.py:92",
            small, wide_solve_launches,
            dict(max_abs_err=err["solve_wide"], ms=tw["solve"],
                 device_ms=tw["solve_device"], plain_ms=tw["solve_plain"],
                 bound=tw["solve_bound"], library_ms=tw["solve_library"]),
            list(WIDE_ROW_SHAPE)),
        row("panel_ldlt", "pyipm_tpu/ops/pallas_ldlt.py:198",
            "pyipm_tpu_torch/csrc/panel_ldlt.cu",
            sum(p["panel_ldlt"] for p in path_launches.values()),
            big["panel_ldlt"], big["panel_ldlt"]["shape"]),
        row("panel_ldlt_batched", "pyipm_tpu/ops/pallas_ldlt.py:198",
            "pyipm_tpu_torch/csrc/panel_ldlt.cu",
            schur["large"]["launches"]["panel_ldlt"],
            schur_kernels["panel_ldlt_batched"], [LARGE["K"], 128, 128]),
        row(f"panel_ldlt_batched_{WIDE_PORTFOLIO['B']}",
            "pyipm_tpu/ops/pallas_ldlt.py:198",
            "pyipm_tpu_torch/csrc/panel_ldlt.cu",
            wide["kernel3_by_b"][str(WIDE_PORTFOLIO["B"])],
            schur_kernels[f"panel_ldlt_batched_{WIDE_PORTFOLIO['B']}"],
            [WIDE_PORTFOLIO["B"], 128, 128]),
        row("ldlt_factor_small_schur", "pyipm_tpu/ops/pallas_ldlt.py:49",
            small, schur["weak"]["launches"]["factor"],
            schur_kernels["ldlt_factor_small_65536x16"], [65_536, 16]),
        row("ldlt_factor_small_n17", "pyipm_tpu/ops/pallas_ldlt.py:49",
            small, schur["general"]["resource_ineq_adaptive"]["launches"][
                "factor"],
            schur_kernels["ldlt_factor_small_16384x17"], [16_384, 17]),
        row("bwd_sweep_panels", "pyipm_tpu/ops/pallas_ldlt.py:523",
            "pyipm_tpu_torch/csrc/bwd_sweep_panels.cu",
            path_launches["ldlt"]["bwd_sweep_panels"],
            big["bwd_sweep_panels"], big["bwd_sweep_panels"]["shape"]),
        row("bwd_sweep_blocks", "pyipm_tpu/ops/pallas_ldlt.py:386",
            "pyipm_tpu_torch/csrc/bwd_sweep_blocks.cu",
            path_launches["condensed"]["bwd_sweep_blocks"],
            big["bwd_sweep_blocks"], big["bwd_sweep_blocks"]["shape"]),
        *f64_record_rows(row, f64),
    ], "launches_by_path": {"fleet": launches, **path_launches,
                            "mehrotra_fleet": mlaunches,
                            "lbfgs_dense": lbfgs["launches"],
                            "lbfgs_block": schur["lbfgs_block"]["launches"],
                            "wide_portfolio": wide["launches"],
                            "cli": facade["launches"],
                            "wave_fleet": wave["launches"],
                            "budget_resume": budget["launches"],
                            "rescue": rescue["launches"],
                            **{f"mixed_{k}": v["launches"]
                               for k, v in mixed.items()}},
        "launches_by_n": {"fleet": launches_n,
                          "wave_fleet": wave["launches_by_n"],
                          "budget_resume": budget["launches_by_n"],
                          "rescue": rescue["launches_by_n"],
                          **{f"mixed_{k}": v["launches_by_n"]
                             for k, v in mixed.items()}},
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
        "fleet": fleet, "kkt_4352": kkt, "dense_nlp": dense,
        "mehrotra_fleet": mehrotra, "lbfgs_dense": lbfgs, "cli": facade,
        "wave_fleet": wave, "budget_resume": budget, "rescue": rescue,
        "mixed_fleet": mixed, "observability": observe,
        "sizes_held_in_phase_18": held_late,
        "ldlt_solve_small_wide_instances_per_sm": err["solve_residency"],
        "schur_factor": schur_factor, "schur": schur,
        "sizes_held_after_phase_23": held_schur,
        "wide_portfolio": wide,
        "float64": {k: v for k, v in f64.items() if k != "kernels"},
        "sizes_held_after_phase_27": held_f64,
        "total_s": time.perf_counter() - T_START}
    print(f"chip_smoke: all phases passed in {record['total_s']:.1f} s")
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        sys.exit(rank_worker(*sys.argv[2:4]))
    sys.exit(main())
