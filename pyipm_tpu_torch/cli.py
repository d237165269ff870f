"""CLI: run the bundled example problems on the card (counterpart of
``pyipm_tpu/cli.py``).

    python -m pyipm_tpu_torch <1..10> [--lbfgs M] [--f32] [--verbosity V]
        [--seed S] [--linear-solver {condensed,ldlt,lu}] [--device {cuda,cpu}]
        [--profile LOGDIR]

The same problems, flags and printout as the reference CLI (pyipm.py:
1866-2137) and ``python -m pyipm_tpu``; ``--device cpu`` runs on the CPU,
and without it the run needs a card.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pyipm_tpu_torch")
    ap.add_argument("problem", type=int, choices=range(1, 11),
                    help="example problem number (reference pyipm.py:"
                         "1920-2131)")
    ap.add_argument("--lbfgs", type=int, default=0,
                    help="L-BFGS memory (0 = exact Hessian)")
    ap.add_argument("--f32", action="store_true",
                    help="use float32 (default float64)")
    ap.add_argument("--verbosity", type=int, default=1)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--linear-solver",
                    choices=["condensed", "ldlt", "lu"], default=None,
                    help="KKT solve method (default: IPMConfig default, "
                         "'condensed')")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the solve runs (default: the card)")
    ap.add_argument("--profile", metavar="LOGDIR", default=None,
                    help="write a Chrome/Perfetto trace of the solve to "
                         "LOGDIR (torch.profiler)")
    args = ap.parse_args(argv)

    from pyipm_tpu_torch.api import IPM
    from pyipm_tpu_torch.models.reference_problems import get_problem

    spec = get_problem(args.problem)
    dtype = np.float32 if args.f32 else np.float64
    rng = np.random.default_rng(args.seed)
    x0 = spec.sample_x0(rng).astype(dtype)

    print(spec.description)
    print("")

    p = IPM(x0=x0, f=spec.f, ce=spec.ce, ci=spec.ci, Ftol=1.0E-8,
            lbfgs=args.lbfgs, float_dtype=dtype, verbosity=args.verbosity,
            linear_solver=args.linear_solver, device=args.device)
    if args.profile:
        from pyipm_tpu_torch.utils.profiling import trace
        with trace(args.profile):
            x, s, lda, fval, kkt = p.solve()
    else:
        x, s, lda, fval, kkt = p.solve()

    print("")
    print("Ground truth (any of): {}".format(
        ["[" + ", ".join(f"{v:.6g}" for v in gt) + "]"
         for gt in spec.ground_truth]))
    print("Solver solution: x = {}".format(x))
    if spec.ci is not None:
        print("Slack variables: s = {}".format(s))
    if spec.ce is not None or spec.ci is not None:
        print("Lagrange multipliers: lda = {}".format(lda))
    print("f(x) = {}".format(fval))
    print("Distance to nearest optimum: {:.3e}".format(
        spec.distance_to_truth(x)))
    print("Karush-Kuhn-Tucker conditions (up to a sign):\n{}".format(kkt))


if __name__ == "__main__":
    main()
