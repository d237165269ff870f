"""Profile one dense-NLP solve of the port on the card: where the wall goes.

    python scripts/profile_dense_nlp.py [--trace-dir DIR]

The instance is the one ``chip_smoke.py`` solves on the card (its
``DENSE_*`` constants: D = 4096, M = 256, 256 tanh features, seed 0,
x0 = 1e-3).  For 'condensed' and for 'ldlt': a warm-up solve from 0,
three unprofiled solves from x0 (their walls), then the same solve under
``torch.profiler`` (CPU and CUDA activities).  Phase labels are wrapped around the solver's
layers from here, by patching module attributes; the package itself is
unchanged.  Prints the walls, the device's busy time and idle share, the
kernel time by name, and host and device time per phase label (a label's
host time includes the labels inside it); with ``--trace-dir``, also
writes a Chrome trace per solver there.  float32, Ktol = 1e-4.  Needs
one CUDA card.
"""

import argparse
import functools
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import (  # noqa: E402
    ProfilerActivity, profile, record_function,
)

from chip_smoke import (  # noqa: E402
    DENSE_D as D, DENSE_H as HIDDEN, DENSE_M as M, DENSE_SEED as SEED,
    DENSE_X0 as X0,
)


def _labeled(name, fn):
    @functools.wraps(fn)
    def inner(*a, **kw):
        with record_function(name):
            return fn(*a, **kw)
    return inner


def install_labels():
    """Wrap the solver's layers in profiler ranges (module attributes the
    callers look up at call time)."""
    from pyipm_tpu_torch.core import kkt, linesearch, problem, solver
    from pyipm_tpu_torch.ops import condensed, linalg

    P = problem.Problem
    for meth, name in (("hess_lagrangian", "autodiff_hessian"),
                       ("grad_f", "autodiff_grad"),
                       ("jac_ce", "autodiff_jacobian")):
        setattr(P, meth, _labeled(name, getattr(P, meth)))
    for mod in (condensed, solver):
        mod.reg_solve_kkt = _labeled("reg_solve_kkt", mod.reg_solve_kkt)
    solver.condensed_direction = _labeled("condensed_direction",
                                          solver.condensed_direction)
    solver.search = _labeled("line_search", solver.search)
    kkt.kkt_norms = _labeled("kkt_norms", kkt.kkt_norms)
    for mod in (kkt, linesearch):
        mod.lstsq_minnorm = _labeled("lstsq_minnorm", mod.lstsq_minnorm)
    for fn in ("ldlt_factor_blocks", "ldlt_factor_panels"):
        setattr(linalg, fn, _labeled("factor", getattr(linalg, fn)))
    linalg.panel_ldlt = _labeled("panel_ldlt_call", linalg.panel_ldlt)
    for fn in ("ldlt_solve_blocks", "ldlt_solve_blocks_bwd",
               "ldlt_solve_panels", "ldlt_solve_panels_bwd"):
        setattr(linalg, fn, _labeled("solve", getattr(linalg, fn)))


LABELS = ("condensed_direction", "reg_solve_kkt", "factor", "panel_ldlt_call",
          "solve", "autodiff_hessian", "autodiff_grad", "autodiff_jacobian",
          "line_search", "lstsq_minnorm", "kkt_norms")


def _dev_time(evt, total=False):
    for name in (("device_time_total", "cuda_time_total") if total
                 else ("self_device_time_total", "self_cuda_time_total")):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_dense_nlp: needs a CUDA card", file=sys.stderr)
        return 1
    from pyipm_tpu_torch import IPMConfig, _sync, solve
    from pyipm_tpu_torch.models.random_nlp import (
        make_dense_nlp_problem, sample_dense_nlp,
    )

    install_labels()
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    problem = make_dense_nlp_problem(D, M)
    data = sample_dense_nlp(SEED, D, M, HIDDEN, device=dev)
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
    for solver in ("condensed", "ldlt"):
        cfg = IPMConfig(float_dtype="float32", verbosity=0, Ktol=1e-4,
                        linear_solver=solver)
        x0 = torch.full((D,), X0, device=dev)
        solve(problem, torch.zeros(D, device=dev), cfg, params=data)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solve(problem, x0, cfg, params=data)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        for k in _sync.COUNTS:
            _sync.COUNTS[k] = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = solve(problem, x0, cfg, params=data)
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t0
        avg = prof.key_averages()
        # device-side events only (kernels, copies, memsets); the host ops
        # that launched them carry the same time and are left out, and so
        # are the annotation spans (these labels, the solver's "ipm-*")
        kernels = [e for e in avg if e.device_type == DeviceType.CUDA
                   and _dev_time(e) > 0 and e.key not in LABELS
                   and not e.key.startswith("ipm-")]
        busy_us = sum(_dev_time(e) for e in kernels)
        print(f"[{solver}] signal {int(res.signal)} iterations "
              f"{int(res.iter_count)}; unprofiled walls (s) "
              f"{', '.join(f'{w:.4f}' for w in walls)}; profiled wall "
              f"{pwall:.4f} s; host syncs {_sync.COUNTS['host_syncs']}, "
              f"flat steps {_sync.COUNTS['flat_steps']}", flush=True)
        med = sorted(walls)[1]
        print(f"[{solver}] device busy {busy_us / 1e3:.3f} ms = "
              f"{busy_us / 1e4 / med:.1f}% of the median unprofiled wall "
              f"{med:.4f} s (idle {100 - busy_us / 1e4 / med:.1f}%)",
              flush=True)
        print(f"[{solver}] kernels by device time (ms, launches):")
        for e in sorted(kernels, key=_dev_time, reverse=True)[:15]:
            print(f"    {_dev_time(e) / 1e3:9.3f}  {e.count:6d}  "
                  f"{e.key[:90]}")
        print(f"[{solver}] phases (host ms incl. nested and the waits of "
              f"host syncs, device ms, calls):")
        for label in LABELS:
            rows = [e for e in avg if e.key == label]
            if rows:
                print(f"    {label:22s} "
                      f"{max(e.cpu_time_total for e in rows) / 1e3:10.3f} "
                      f"{max(_dev_time(e, True) for e in rows) / 1e3:10.3f} "
                      f"{max(e.count for e in rows):5d}")
        launches = sum(e.count for e in avg if e.key in (
            "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
            "cudaLaunchCooperativeKernel"))
        print(f"[{solver}] kernel launch calls {launches}", flush=True)
        if args.trace_dir:
            prof.export_chrome_trace(os.path.join(
                args.trace_dir, f"profile_dense_{solver}.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
