"""Profiling and observability (counterpart of
``pyipm_tpu/utils/profiling.py``).

  - :func:`annotate` -- a named scope: a ``torch.profiler`` range, and an
    NVTX range when the work is on the card.  :data:`SCOPES` lists every
    scope of the package: the solver's phases (``ipm-init``, ``ipm-loop``,
    ``ipm-finalize``; inside the loop ``ipm-direction``,
    ``ipm-line-search`` with its ``ipm-soc``, ``ipm-kkt-residual``,
    ``ipm-outer-epilogue``), the derivatives (``ipm-hessian``,
    ``ipm-jacobian``), ``reg_solve_kkt``'s ``ipm-kkt-factor`` and
    ``ipm-kkt-solve``, and each kernel wrapper, checks and launch
    included (``ipm-k1-factor``, ``ipm-k2-solve``, ``ipm-k3-panel``,
    ``ipm-k4-sweep-panels``, ``ipm-k5-sweep-blocks``);
  - :func:`trace` -- ``torch.profiler`` around a block, CPU and (on the
    card) CUDA activities, exported as a Chrome/Perfetto trace;
  - :func:`profile_solve` -- first-call wall and median steady wall of a
    solve, with its iteration throughput;
  - :func:`iteration_report` -- the per-iteration table of a
    ``trace_metrics=True`` solve;
  - :func:`enable_nan_debugging` -- the counterpart of ``jax_debug_nans``:
    the solver raises ``FloatingPointError`` at the first flat step that
    makes a non-finite iterate.  The always-on guard is the solver's own
    (``IPMConfig.nan_guard``, signal -3).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

# every scope name the package's code opens with :func:`annotate`
SCOPES = ("ipm-direction", "ipm-line-search", "ipm-kkt-residual",
          "ipm-outer-epilogue", "ipm-kkt-factor", "ipm-kkt-solve",
          "ipm-init", "ipm-loop", "ipm-finalize", "ipm-hessian",
          "ipm-jacobian", "ipm-soc", "ipm-k1-factor", "ipm-k2-solve",
          "ipm-k3-panel", "ipm-k4-sweep-panels", "ipm-k5-sweep-blocks")
# the scopes of SCOPES that a K <= 128 solve taking no second-order
# correction (the QP fleet, reference problem 7) does not open
NOT_IN_SMALL_SOLVE = ("ipm-soc", "ipm-k3-panel", "ipm-k4-sweep-panels",
                      "ipm-k5-sweep-blocks")

_nan_debug = False


def enable_nan_debugging(enable: bool = True):
    """Process-wide: make every solve check, after each flat step, that
    the instances it stepped have finite x, s, lda and KKT norms, and raise
    ``FloatingPointError`` naming the first field that is not (while on,
    one host sync per flat step that takes an inner iteration; nothing
    while off)."""
    global _nan_debug
    _nan_debug = bool(enable)


def nan_debugging() -> bool:
    return _nan_debug


@contextlib.contextmanager
def annotate(name: str, device=None):
    """Label a block ``name`` in a ``torch.profiler`` trace, and in an NVTX
    range when ``device`` is a CUDA device."""
    nvtx = device is not None and torch.device(device).type == "cuda"
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (CPU activities, and CUDA ones when a card is
    present) and write ``trace_<pid>_<ns>.json`` (Chrome trace format,
    readable by Perfetto) into ``logdir``.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


# ----------------------------------------------------------------------
@dataclasses.dataclass
class SolveProfile:
    """Structured result of :func:`profile_solve`.  The JAX package's
    ``flops`` and ``hbm_bytes`` (XLA cost analysis) and the rates derived
    from them have no source here and are left out."""
    compile_s: float            # first-call wall (kernel build, cuBLAS
    #                             init, autodiff set-up, the solve)
    execute_s: float            # median steady wall
    reps: int
    total_iters: Optional[int]  # summed iter_count if the result has one
    iters_per_s: Optional[float]
    backend: str                # device type and the card's name

    def __str__(self):
        lines = [f"first call {self.compile_s:.3f}s | execute "
                 f"{self.execute_s * 1e3:.2f}ms (median of {self.reps}) on "
                 f"{self.backend}"]
        if self.total_iters is not None:
            lines.append(f"{self.total_iters} solver iterations"
                         + (f" -> {self.iters_per_s:.1f} iters/s"
                            if self.iters_per_s else ""))
        return "\n".join(lines)


def _sync_device(out):
    dev = getattr(getattr(out, "x", None), "device", None)
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return dev


def profile_solve(fn: Callable, *args, reps: int = 5) -> SolveProfile:
    """Time ``fn(*args)``: the first call's wall, then the median of
    ``reps`` further calls, each ending in a device synchronisation; the
    iteration throughput from the result's ``iter_count``."""
    t0 = time.perf_counter()
    out = fn(*args)
    dev = _sync_device(out)
    compile_s = time.perf_counter() - t0
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        _sync_device(out)
        walls.append(time.perf_counter() - t0)
    execute_s = float(np.median(walls))
    total_iters = iters_per_s = None
    ic = getattr(out, "iter_count", None)
    if ic is not None:
        total_iters = int(torch.as_tensor(ic).sum())
        iters_per_s = total_iters / execute_s if execute_s > 0 else None
    backend = "cpu" if dev is None else dev.type
    if dev is not None and dev.type == "cuda":
        backend = f"cuda ({torch.cuda.get_device_name(dev)})"
    return SolveProfile(
        compile_s=compile_s, execute_s=execute_s, reps=reps,
        total_iters=total_iters, iters_per_s=iters_per_s, backend=backend)


def iteration_report(result, i: int = 0) -> str:
    """Per-iteration table of instance ``i`` of a batched result (or of an
    unbatched one) from a ``trace_metrics=True`` solve."""
    hist = result.hist
    kkt = hist.kkt.detach().cpu().numpy()
    batched = kkt.ndim == 3
    pick = (lambda a: a[i]) if batched else (lambda a: a)
    kkt = pick(kkt)
    if kkt.shape[0] == 0:
        return ("no metrics recorded — solve with "
                "IPMConfig(trace_metrics=True)")
    n = int(pick(result.iter_count.detach().cpu().numpy()))
    mu, nu, alpha, delta = (pick(getattr(hist, k).detach().cpu().numpy())
                            for k in ("mu", "nu", "alpha", "delta"))
    head = (f"{'it':>4} {'|dLdx|':>10} {'|dLds|':>10} {'|ce|':>10} "
            f"{'|ci-s|':>10} {'mu':>10} {'nu':>10} {'alpha':>8} "
            f"{'delta':>8}")
    rows = [head, "-" * len(head)]
    for t in range(n):
        rows.append(
            f"{t + 1:>4} {kkt[t, 0]:>10.3e} {kkt[t, 1]:>10.3e} "
            f"{kkt[t, 2]:>10.3e} {kkt[t, 3]:>10.3e} {mu[t]:>10.3e} "
            f"{nu[t]:>10.3e} {alpha[t]:>8.3f} {delta[t]:>8.1e}")
    return "\n".join(rows)
