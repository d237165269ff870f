"""Step the JAX package and the port through the dense NLP one inner
iteration at a time on the CPU, and print where their iterates part.

    python scripts/dense_nlp_step_compare.py [--dtype float32|float64]
        [--solver condensed|ldlt] [--D D --M M --hidden H] [--iters N]

The instance is ``chip_smoke.py``'s dense NLP (its ``DENSE_*`` constants:
D = 4096, M = 256, 256 tanh features, seed 0, x0 = 1e-3 * ones), drawn by
the port's ``sample_dense_arrays`` and handed to both packages as arrays.
After each inner iteration the script prints, for the JAX package
(``run_budget(st, 1)``) and the port (flat steps until the iteration count
moves), the barrier mu, penalty nu, shift delta, inertia retries, step
length alpha, the four KKT norms, the same norms evaluated in float64 at
the same iterate by the JAX package's ``kkt_norms`` (``kkt64``: how much
of a norm is the working precision's roundoff) and max |x_jax - x_port|.
It also restarts the port from the JAX package's state before the
iteration and takes that one step (``same iterate``): what differs there is
the step's own arithmetic, not what earlier steps accumulated.  ``--D``, ``--M``,
``--hidden`` shrink the instance.  Needs JAX; two to three minutes per
iteration at D = 4096.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (  # noqa: E402
    DENSE_D, DENSE_H, DENSE_M, DENSE_SEED, DENSE_X0,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--solver", default="condensed",
                    choices=("condensed", "ldlt"))
    ap.add_argument("--D", type=int, default=DENSE_D)
    ap.add_argument("--M", type=int, default=DENSE_M)
    ap.add_argument("--hidden", type=int, default=DENSE_H)
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    import torch

    from pyipm_tpu.config import IPMConfig as JCfg
    from pyipm_tpu.core import kkt as JK
    from pyipm_tpu.core.solver import make_solver as j_make_solver
    from pyipm_tpu.models import random_nlp as JR
    from pyipm_tpu_torch.core.solver import BatchSolver, SolverState
    from pyipm_tpu_torch.interop import config_from_dict, dense_from_numpy
    from pyipm_tpu_torch.models.random_nlp import (
        make_dense_nlp_problem, sample_dense_arrays,
    )
    import dataclasses

    D, M = args.D, args.M
    arr = sample_dense_arrays(DENSE_SEED, D, M, args.hidden,
                              np.dtype(args.dtype))
    jdata = JR.DenseNLPData(*(jnp.asarray(arr[k])
                              for k in JR.DenseNLPData._fields))
    jcfg = JCfg(float_dtype=args.dtype, verbosity=0, Ktol=1e-4,
                linear_solver=args.solver)
    jfn = j_make_solver(JR.make_dense_nlp_problem(jdata, D, M), jcfg)
    jprob64 = JR.make_dense_nlp_problem(JR.DenseNLPData(*(
        jnp.asarray(arr[k], jnp.float64) for k in JR.DenseNLPData._fields)),
        D, M)
    kkt64 = jax.jit(lambda x, s, lda, mu: JK.kkt_norms(jprob64, x, s, lda,
                                                       mu))
    jinit = jax.jit(jfn.init_state)
    jstep = jax.jit(jfn.run_budget)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    solver = BatchSolver(make_dense_nlp_problem(D, M), cfg)
    tdata = dense_from_numpy(jdata, device="cpu")
    params = type(tdata)(*(t[None] for t in tdata))
    x0 = np.full((D,), DENSE_X0, np.dtype(args.dtype))

    def port_from_jax(js):
        """The port's state (B = 1) carrying the JAX state's fields."""
        return SolverState(*(
            torch.as_tensor(np.array(getattr(js, k)))[None]
            for k in SolverState._fields[:16]))

    def port_step(st):
        """Flat steps until the iteration count moves or the solve ends."""
        with torch.no_grad():
            before = int(st.iter_count[0])
            while int(st.iter_count[0]) == before:
                running = (st.outer < cfg.niter) & (st.signal == 0)
                if not bool(running.any()):
                    break
                st = solver.flat_step(st, running, params)
        return st

    def row(name, st):
        g = (lambda k: np.asarray(getattr(st, k)).reshape(-1))
        kkt = " ".join(f"{v:.6e}" for v in g("kkt"))
        k64 = kkt64(*(jnp.asarray(g(k), jnp.float64)
                      for k in ("x", "s", "lda")),
                    jnp.asarray(g("mu")[0], jnp.float64))
        k64 = " ".join(f"{v:.6e}" for v in np.asarray(k64))
        return (f"  {name:12s} it {int(g('iter_count')[0])} outer "
                f"{int(g('outer')[0])} sig {int(g('signal')[0])} mu "
                f"{g('mu')[0]:.6e} nu {g('nu')[0]:.6e} delta "
                f"{g('delta')[0]:.6e} retries {int(g('reg_retries')[0])} "
                f"alpha {g('alpha')[0]:.9e} kkt [{kkt}] kkt64 [{k64}]")

    jst = jinit(jnp.asarray(x0))
    with torch.no_grad():
        tst = solver.init_state(torch.as_tensor(x0)[None], params)
    print(f"D={D} M={M} hidden={args.hidden} {args.dtype} {args.solver}")
    print(row("jax init", jst))
    print(row("port init", tst))
    for _ in range(args.iters):
        same = port_step(port_from_jax(jst))
        jst = jstep(jst, 1)
        tst = port_step(tst)
        jx = np.asarray(jst.x)
        print(row("jax", jst))
        print(row("port", tst))
        print(row("same iterate", same))
        dx = np.abs(jx - tst.x[0].numpy()).max()
        dx_same = np.abs(jx - same.x[0].numpy()).max()
        print(f"  max|x_jax - x_port| {dx:.3e}, same iterate {dx_same:.3e}",
              flush=True)
        if int(jst.signal) and int(tst.signal[0]):
            break


if __name__ == "__main__":
    main()
