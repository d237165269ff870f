"""Where an iteration of ``chip_smoke.py``'s phase 26 goes on the card.

    python scripts/profile_wide_fleet.py [--batch B] [--assets D]
                                         [--hessian-chunk C]

The fleet is phase 26's (``chip_smoke.WIDE_PORTFOLIO``: 1,024 Markowitz
portfolios of 500 assets from ``SEED``, float32, the default config).  Two
warm iterations, then three under ``torch.profiler``: the wall, the device's
busy time, the solver's ``ipm-*`` scopes and the kernels by device time.
Then the pieces of one iteration at the fleet's first iterate, each timed
alone (best of two, host clock around a synchronised call): the three
autodiff Hessians as the solver takes them, ``torch.func.hessian`` over
chunks of C instances (what the whole batch cannot hold), forward over
``grad`` on the whole batch with its extra peak allocation, the inequality
Jacobian, the condensed system, ``reg_solve_kkt`` (the batched K > 128
path), one further solve through its factors, the blocked factor alone and
one whole iteration.  Needs one CUDA card.
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.func import grad, hessian, jacfwd, vmap  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from chip_smoke import SEED, WIDE_PORTFOLIO  # noqa: E402


def timed(fn, what, reps=2):
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"  {what}: {min(walls) * 1e3:.1f} ms", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=WIDE_PORTFOLIO["B"])
    ap.add_argument("--assets", type=int, default=WIDE_PORTFOLIO["D"])
    ap.add_argument("--hessian-chunk", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_wide_fleet: needs a CUDA card")
    from pyipm_tpu_torch import IPMConfig
    from pyipm_tpu_torch.config import matmul_precision
    from pyipm_tpu_torch.core import kkt as K
    from pyipm_tpu_torch.core.solver import BatchSolver
    from pyipm_tpu_torch.models import applications as app
    from pyipm_tpu_torch.ops import _build, linalg as lin
    from pyipm_tpu_torch.ops.condensed import _Condensed, _split

    _build.build()
    _build.load()
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(f"card: {smi}", flush=True)
    Bn, Dn = args.batch, args.assets
    data = app.portfolio_data(app.sample_portfolio_arrays(SEED, Bn, Dn),
                              device=dev)
    x0 = app.portfolio_x0(Bn, Dn, device=dev)
    prob = app.make_portfolio_problem(Dn)
    cfg = IPMConfig(float_dtype="float32", verbosity=0)
    solver = BatchSolver(prob, cfg)
    st = solver.init_state(x0, data)
    solver.run_budget(st, 2, data)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.run_budget(st, 3, data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    kernels = [e for e in ka if e.device_type == DeviceType.CUDA
               and not e.key.startswith("ipm-")]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"B={Bn} D={Dn}: 3 iterations, wall {wall:.3f} s, device busy "
          f"{busy:.1f} ms (idle {100 * (1 - busy / 1e3 / wall):.1f}%)")
    for e in sorted((e for e in ka if e.key.startswith("ipm-")
                     and e.device_type == DeviceType.CPU),
                    key=lambda e: -e.cpu_time_total):
        print(f"  scope {e.key:20s} x{e.count:<4d} host "
              f"{e.cpu_time_total / 1e3:9.1f} ms")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.1f} ms x{e.count:<6d} "
              f"{e.key[:100]}")

    x, lda = st.x, st.lda
    C = args.hessian_chunk
    with matmul_precision(cfg.matmul_precision):
        timed(lambda: prob.hess_f(x, data), "hess_f (as the solver takes it)")
        timed(lambda: prob.hess_ce(x, lda, data), "hess_ce")
        timed(lambda: prob.hess_ci(x, lda, data), "hess_ci")
        timed(lambda: torch.cat([
            vmap(hessian(prob._f1))(x[i:i + C], type(data)(
                *(t[i:i + C] for t in data))) for i in range(0, Bn, C)]),
            f"torch.func.hessian of f in chunks of {C} instances")
        torch.cuda.reset_peak_memory_stats(dev)
        m0 = torch.cuda.memory_allocated(dev)
        timed(lambda: vmap(jacfwd(grad(prob._f1)))(x, data),
              "forward over grad of f, the whole batch")
        print(f"    its extra peak allocation "
              f"{torch.cuda.max_memory_allocated(dev) - m0} B")
        timed(lambda: prob.jac_ci(x, data), "jac_ci")
        timed(lambda: _Condensed(prob, x, st.s, lda, data),
              "the condensed system (Hessians, Jacobians, products)")
        cond = _Condensed(prob, x, st.s, lda, data)
        rhs = cond.rhs(*_split(prob, -K.grad(prob, x, st.s, lda, st.mu,
                                              data)))
        kw = dict(nvar=Dn, neq=prob.neq, nineq=0, eps=cfg.eps,
                  reg_coef=cfg.reg_coef, eta=cfg.eta, beta=cfg.beta,
                  delta0=cfg.delta0, max_retries=cfg.max_reg_retries,
                  want_solver=True, block=cfg.ldlt_block)
        timed(lambda: lin.reg_solve_kkt(cond.Kc, rhs, st.delta, st.mu, **kw),
              "reg_solve_kkt (batched, K > 128)")
        out = lin.reg_solve_kkt(cond.Kc, rhs, st.delta, st.mu, **kw)
        timed(lambda: out[3](rhs), "a further solve through its factors")
        timed(lambda: lin.ldlt_factor_batched(cond.Kc, padded=True),
              "ldlt_factor_batched")
        timed(lambda: solver.run_budget(st, 1, data), "one iteration")


if __name__ == "__main__":
    main()
