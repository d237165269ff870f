"""Worker for tests/test_torch_distributed.py, started by the port's
launcher (``python -m pyipm_tpu_torch.parallel.launch --spawn N``): joins
the ranks through the ``PYIPM_*`` environment on gloo, solves the same
block-separable instances at any world size (each rank its blocks, in
exact-Hessian and in L-BFGS mode), and rank 0 writes every solve's
signal, iterations and x, and the most all-reduces any inner iteration
asked for, and a batch-axis fleet solved cold and with per-instance warm
starts (mu0, nu0), to the ``.npz`` named by its argument.
``--fail-rank R`` makes rank R exit 3 before joining (the launcher's
fail-fast fixture).  ``main([path])`` runs it in the calling process at
world size 1."""

import os
import sys

import numpy as np
import torch

from pyipm_tpu_torch.config import IPMConfig
from pyipm_tpu_torch.models.reference_problems import get_problem
from pyipm_tpu_torch.parallel import distributed as dist
from pyipm_tpu_torch.parallel.batch import make_batch_solver
from pyipm_tpu_torch.parallel import schur as TS
from pyipm_tpu_torch.parallel.launch import ENV_PROC_ID


def per_iteration_calls(fn, x0, th, cc):
    """The most all-reduces any single inner iteration (its epilogue
    included) asks for: the solve advanced one iteration at a time."""
    st = fn.init_state(x0, th, cc)
    worst = 0
    while int(st.signal[0]) == 0 and int(st.outer[0]) < fn.config.niter:
        before = fn.reducer.total
        st = fn.run_budget(st, th, cc, max_new_iters=1)
        worst = max(worst, fn.reducer.total - before)
    return worst


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    rank = int(os.environ.get(ENV_PROC_ID, "0"))
    if "--fail-rank" in argv:
        if rank == int(argv[argv.index("--fail-rank") + 1]):
            sys.exit(3)
    dist.initialize(device="cpu")
    ranks = dist.world_size()
    mesh = (dist.global_solver_mesh(batch=1, model=ranks, device="cpu")
            if ranks > 1 else None)
    out = {"world_size": ranks}

    def solve(name, spec, th, cc, x0, cfg):
        fn = TS.make_block_solver(spec, mesh, cfg, device="cpu")
        res = fn(x0, th, cc)
        out[name + "_x"] = res.x.numpy()
        out[name + "_sig"] = int(res.signal)
        out[name + "_it"] = int(res.iter_count)
        return fn

    f64 = IPMConfig(float_dtype="float64", verbosity=0, niter=10, miter=25)
    g = torch.Generator().manual_seed(0)
    spec, data, x0 = TS.sample_separable(g, 8, 4, 3, dtype=torch.float64,
                                         device="cpu")
    solve("separable", TS.separable_block_spec(spec),
          {"user": data.theta, "A": data.A, "lb": data.lb},
          {"b": data.b}, x0, f64)
    spec, th, cc, x0 = TS.sample_block_general(g, 8, 3, me=1, ni=2, p=2,
                                               mc=1, device="cpu")
    solve("general", spec, th, cc, x0, f64)
    solve("lbfgs", spec, th, cc, x0, f64.replace(lbfgs=6, niter=20,
                                                   miter=40))

    # the collective census's configurations (float32, defaults)
    f32 = IPMConfig(float_dtype="float32", verbosity=0)
    for name, kw in (("linear_cc", dict(d=16, mci=0, nonlinear_cc=False)),
                     ("coupled", dict(d=3, mci=1))):
        spec, th, cc, x0 = TS.sample_block_general(
            g, 8, me=1, ni=2, p=2, mc=1, dtype=torch.float32,
            device="cpu", **kw)
        fn = TS.make_block_solver(spec, mesh, f32, device="cpu")
        out[name + "_calls"] = per_iteration_calls(fn, x0, th, cc)
        if name == "coupled":
            # the census's L-BFGS row: the same instance, L-BFGS(6)
            fn = TS.make_block_solver(
                spec, mesh, f32.replace(lbfgs=6, niter=20, miter=40),
                device="cpu")
            out["lbfgs_calls"] = per_iteration_calls(fn, x0, th, cc)
    # the batch axis: examples/distributed_fleet.py's fleet, then with
    # per-instance warm starts mu0, nu0 (B,), split with the batch
    bmesh = (dist.global_solver_mesh(batch=ranks, model=1, device="cpu")
             if ranks > 1 else None)
    prob = get_problem(9)
    rng = np.random.default_rng(7)
    xb = torch.tensor(np.stack([prob.sample_x0(rng) for _ in range(8)]),
                      dtype=torch.float64)
    warm = torch.linspace(0.05, 0.4, 8, dtype=torch.float64)
    fleet = make_batch_solver(prob.make(), IPMConfig(verbosity=0),
                              mesh=bmesh)
    for name, kw in (("fleet", {}), ("warm", dict(mu0=warm, nu0=10 * warm))):
        res = fleet(xb, **kw)
        out[name + "_x"] = res.x.numpy()
        out[name + "_sig"] = res.signal.numpy()
        out[name + "_it"] = res.iter_count.numpy()
    if dist.rank() == 0:
        np.savez(argv[0], **out)
    dist.shutdown()


if __name__ == "__main__":
    main()
