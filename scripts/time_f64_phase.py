"""Run phase 27 of ``chip_smoke.py`` (the package's default float64 at
full size) alone on the card, and time what its busy-share profile costs.

    python scripts/time_f64_phase.py [--profiler-cost]

Builds the kernels and calls ``chip_smoke.f64_phase``: every cell's
solve, busy share, input digests and hold, the launch check and the
float64 kernel rows, printed as in the full run, with the seconds of each
cell (alone, the wide cell draws its portfolios itself, ~20 s that the
full run takes in phase 26).  ``--profiler-cost`` first profiles 3 inner
iterations of the float64 MPC bucket (phase 16's, 2,048 instances) with
the host's and the device's activity recorded, then with the device's
alone (``chip_smoke.busy_share``), and prints each one's busy ms, the
profiled wall and the seconds the call took, post-processing included.
Needs one CUDA card.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def profiler_cost(cs, device):
    """busy_share's reading and cost on the float64 MPC bucket, recording
    the host's activity too, then the device's alone."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pyipm_tpu_torch import IPMConfig, solve_fleet
    from pyipm_tpu_torch.core.linesearch import take
    from pyipm_tpu_torch.core.solver import BatchSolver

    def with_host(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and not e.key.startswith("ipm-"))
        return None, us / 1e3, wall, 1.0 - us / 1e6 / wall

    cfg = IPMConfig(verbosity=0, Ktol=1e-4)
    prob, data, x0 = cs.mixed_buckets(device, np.float64)["mpc"]
    solve_fleet([prob] * 64, list(x0[:64]), cfg, params=[
        take(data, i) for i in range(64)], device=device)      # warm-up
    solver = BatchSolver(prob, cfg)
    st0 = solver.init_state(x0, data)
    for what, share in (("host and device", with_host),
                        ("device alone", cs.busy_share)):
        t0 = time.perf_counter()
        _, busy, wall, idle = share(lambda: solver.run_budget(st0, 3, data))
        print(f"busy share, {what} recorded: busy {busy:.3f} ms of "
              f"{wall:.3f} s (idle {100 * idle:.1f}%), the call "
              f"{time.perf_counter() - t0:.2f} s", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profiler-cost", action="store_true")
    args = ap.parse_args()
    import subprocess

    import torch

    import chip_smoke as cs
    from pyipm_tpu_torch import _sync
    from pyipm_tpu_torch.ops import _build, large_ldlt as ll, linalg as lin
    from pyipm_tpu_torch.ops import small_ldlt as sl

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    _build.build(force=True)
    _build.load()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    device = torch.device("cuda:0")
    if args.profiler_cost:
        profiler_cost(cs, device)
    counters = (sl.LAUNCHES, sl.LAUNCHES_BY_N, ll.LAUNCHES,
                ll.LAUNCHES_BY_B, _sync.COUNTS)
    cs.f64_phase(counters, sl, ll, lin, _sync, device)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
