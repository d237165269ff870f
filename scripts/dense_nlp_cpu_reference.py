"""Solve one numpy-seeded dense NLP on the CPU: the convergence reference
for the port's dense-NLP solve on the card.

    python scripts/dense_nlp_cpu_reference.py [--solver condensed|ldlt]
        [--package jax|port]

The instance is the one ``chip_smoke.py`` solves on the card (its
``DENSE_*`` constants: D = 4096, M = 256, 256 tanh features, seed 0,
x0 = 1e-3 * ones), made by the port's ``sample_dense_arrays`` in float32.
``--package jax`` (the default) hands it to the JAX package's
``make_dense_nlp_solver`` as arrays; ``--package port`` solves it with the
port on CPU tensors (the kernels' plain versions).  One solve at
Ktol = 1e-4 with the default adaptive barrier.  Prints one JSON line:
signal, iterations, final f, max KKT norm and the wall (JAX compilation
included).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (  # noqa: E402
    DENSE_D as D, DENSE_H as HIDDEN, DENSE_M as M, DENSE_SEED as SEED,
    DENSE_X0 as X0,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--solver", default="condensed",
                    choices=("condensed", "ldlt"))
    ap.add_argument("--package", default="jax", choices=("jax", "port"))
    args = ap.parse_args()
    if args.package == "port":
        return solve_with_port(args.solver)

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from pyipm_tpu.config import IPMConfig
    from pyipm_tpu.models.random_nlp import DenseNLPData, make_dense_nlp_solver
    from pyipm_tpu_torch.models.random_nlp import sample_dense_arrays

    arr = sample_dense_arrays(SEED, D, M, HIDDEN)
    data = DenseNLPData(*(jnp.asarray(arr[k]) for k in DenseNLPData._fields))
    cfg = IPMConfig(float_dtype="float32", verbosity=0, Ktol=1e-4,
                    linear_solver=args.solver)
    fn = make_dense_nlp_solver(cfg, D, M)
    x0 = jnp.full((D,), X0, jnp.float32)
    t0 = time.perf_counter()
    res = jax.block_until_ready(fn(x0, data))
    wall = time.perf_counter() - t0
    print(json.dumps({
        "D": D, "M": M, "hidden": HIDDEN, "seed": SEED, "x0": X0,
        "solver": args.solver, "dtype": "float32",
        "signal": int(res.signal), "iters": int(res.iter_count),
        "fval": float(res.fval), "kkt_max": float(np.asarray(res.kkt).max()),
        "wall_s_with_compile": wall, "backend": jax.default_backend(),
    }))


def solve_with_port(solver):
    import numpy as np
    import torch

    from pyipm_tpu_torch import IPMConfig, solve
    from pyipm_tpu_torch.models.random_nlp import (
        make_dense_nlp_problem, sample_dense_nlp,
    )

    data = sample_dense_nlp(SEED, D, M, HIDDEN, device="cpu")
    cfg = IPMConfig(float_dtype="float32", verbosity=0, Ktol=1e-4,
                    linear_solver=solver)
    t0 = time.perf_counter()
    res = solve(make_dense_nlp_problem(D, M), torch.full((D,), X0), cfg,
                params=data)
    wall = time.perf_counter() - t0
    print(json.dumps({
        "D": D, "M": M, "hidden": HIDDEN, "seed": SEED, "x0": X0,
        "solver": solver, "dtype": "float32",
        "signal": int(res.signal), "iters": int(res.iter_count),
        "fval": float(res.fval), "kkt_max": float(np.asarray(res.kkt).max()),
        "wall_s": wall, "package": "pyipm_tpu_torch", "device": "cpu",
    }))


if __name__ == "__main__":
    main()
