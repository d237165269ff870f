"""Profile one fleet solve of the port on the card: where the wall goes.

    python scripts/profile_fleet.py [--trace-dir DIR] [--root DIR]
                                    [--save FILE.npz] [--compare FILE.npz]
                                    [--mu-strategy adaptive|mehrotra]

The fleet is the one ``chip_smoke.py`` solves on the card (its ``SEED``,
``B``, ``D``, ``NLIN`` constants: 10,000 random QPs, D = 16, float32,
Ktol = 1e-4, x0 = 1e-6 N(0, 1) from numpy seed 7), with the 'adaptive'
barrier or, by ``--mu-strategy``, the Mehrotra predictor-corrector.  A
warm-up solve from 0,
three unprofiled solves from x0 (their walls), then the same solve under
``torch.profiler`` (CPU and CUDA activities).  Prints the walls, the hit
rate and mean iterations, the device's busy time and idle share, kernel
launches per flat step, the device time and launches of the two
hand-written kernels (``ldlt_factor_kernel``, ``ldlt_solve_kernel``) and
their share of the busy time, and the kernels by device time.  The two
kernels' launches, instances and device time are also split by system
size n (16: the condensed systems, 36: the SOC normal matrices): launches
and instances from the wrappers' calls, device time from the kernel's
template name where it carries the size bucket.  With ``--trace-dir``,
also writes a Chrome trace there; ``--root`` imports the package from
another checkout (a parent tree, to compare two in one call); ``--save``
writes the profiled solve's per-instance signals, iteration counts and x,
and ``--compare`` holds them against such a file.  Needs one CUDA card.
"""

import argparse
import collections
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from chip_smoke import B, D, NLIN, SEED  # noqa: E402

OWN_KERNELS = ("ldlt_factor_kernel", "ldlt_solve_kernel")
SCOPE_PREFIX = "ipm-"
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cudaLaunchCooperativeKernel")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--root", default=None)
    ap.add_argument("--save", default=None)
    ap.add_argument("--compare", default=None)
    ap.add_argument("--mu-strategy", default="adaptive",
                    choices=("adaptive", "mehrotra"))
    args = ap.parse_args()
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    if not torch.cuda.is_available():
        print("profile_fleet: needs a CUDA card", file=sys.stderr)
        return 1
    from pyipm_tpu_torch import IPMConfig, _sync, solve_batch
    from pyipm_tpu_torch.models.random_nlp import (
        make_qp_problem, sample_qp_batch,
    )
    from pyipm_tpu_torch.ops import linalg as lin
    from pyipm_tpu_torch.ops import small_ldlt as sl

    print(f"package: {os.path.dirname(sl.__file__)}", flush=True)
    # calls and instances of the two kernels' wrappers by (kernel, n); the
    # solver reaches them through ops/linalg.py's names
    calls = collections.Counter()
    insts = collections.Counter()

    def tally(kind, fn):
        def wrapped(M, *a, **kw):
            calls[kind, M.shape[-1]] += 1
            insts[kind, M.shape[-1]] += M.shape[0]
            return fn(M, *a, **kw)
        return wrapped

    lin.ldlt_factor_small = tally("factor", lin.ldlt_factor_small)
    lin.ldlt_solve_small = tally("solve", lin.ldlt_solve_small)

    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}; mu_strategy "
          f"{args.mu_strategy}", flush=True)
    cfg = IPMConfig(float_dtype="float32", verbosity=0, Ktol=1e-4,
                    mu_strategy=args.mu_strategy)
    problem = make_qp_problem(D, NLIN)
    data = sample_qp_batch(SEED, B, D, NLIN, dtype="float32", device=dev)
    solve_batch(problem, torch.zeros((B, D), device=dev), cfg, params=data)
    x0 = torch.as_tensor(
        1e-6 * np.random.default_rng(7).standard_normal((B, D)),
        dtype=torch.float32, device=dev)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve_batch(problem, x0, cfg, params=data)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    for counts in (_sync.COUNTS, sl.LAUNCHES):
        for k in counts:
            counts[k] = 0
    calls.clear()
    insts.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = solve_batch(problem, x0, cfg, params=data)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    sig = res.signal.cpu().numpy()
    its = res.iter_count.cpu().numpy()
    steps = _sync.COUNTS["flat_steps"]
    print(f"hit rate {float(np.mean(np.isin(sig, (1, 2)))):.4f}, mean "
          f"iterations {its.mean():.3f}, max {int(its.max())}; unprofiled "
          f"walls (s) {', '.join(f'{w:.4f}' for w in walls)}; profiled wall "
          f"{pwall:.4f} s; flat steps {steps}, host syncs "
          f"{_sync.COUNTS['host_syncs']}; wrapper launches "
          f"{dict(sl.LAUNCHES)}", flush=True)
    avg = prof.key_averages()
    # device-side events only (kernels, copies, memsets); the solver's
    # "ipm-*" scopes also show on the device as annotation spans over
    # kernels already counted, so they are left out
    kernels = [e for e in avg if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0
               and not e.key.startswith(SCOPE_PREFIX)]
    busy_us = sum(e.self_device_time_total for e in kernels)
    med = sorted(walls)[1]
    print(f"device busy {busy_us / 1e3:.3f} ms = {busy_us / 1e4 / med:.1f}% "
          f"of the median unprofiled wall {med:.4f} s (idle "
          f"{100 - busy_us / 1e4 / med:.1f}%)", flush=True)
    launches = sum(e.count for e in avg if e.key in LAUNCH_CALLS)
    print(f"kernel launch calls {launches}, {launches / max(steps, 1):.1f} "
          f"per flat step", flush=True)
    own_us = 0.0
    for name in OWN_KERNELS:
        rows = [e for e in kernels if name in e.key]
        us = sum(e.self_device_time_total for e in rows)
        own_us += us
        print(f"{name}: {us / 1e3:.3f} ms in {sum(e.count for e in rows)} "
              f"launches", flush=True)
    print(f"the two hand-written kernels: {own_us / 1e3:.3f} ms = "
          f"{100 * own_us / busy_us:.1f}% of device busy", flush=True)
    for kind, n in sorted(calls):
        print(f"{kind} n={n}: {calls[kind, n]} calls, {insts[kind, n]} "
              f"instances ({insts[kind, n] / calls[kind, n]:.1f} a call)",
              flush=True)
    for name in OWN_KERNELS:
        for e in kernels:
            if name in e.key:
                print(f"    {e.self_device_time_total / 1e3:9.3f} ms "
                      f"{e.count:6d} launches  {e.key[:110]}", flush=True)
    print("kernels by device time (ms, launches):")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:15]:
        print(f"    {e.self_device_time_total / 1e3:9.3f}  {e.count:6d}  "
              f"{e.key[:90]}")
    if args.save:
        np.savez(args.save, signal=sig, iters=its, x=res.x.cpu().numpy())
    if args.compare:
        ref = np.load(args.compare)
        x = res.x.cpu().numpy()
        dx = np.abs(x - ref["x"]) / (1 + np.abs(ref["x"]))
        print(f"against {args.compare}: signals equal "
              f"{int(np.sum(sig == ref['signal']))}/{sig.size}, iterations "
              f"equal {int(np.sum(its == ref['iters']))}/{its.size}, max "
              f"|dx|/(1+|x|) {float(dx.max()):.3e}", flush=True)
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace_dir,
                                              "profile_fleet.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
