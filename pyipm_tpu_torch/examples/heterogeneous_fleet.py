"""A heterogeneous fleet: mixed problem shapes in one call.

``solve_fleet`` groups instances that share a Problem and the shapes of
their data, solves each group through the wave solver and the rest one by
one, and returns per-instance results in order.  Here: box QPs of
dimension 2 and 4 (one Problem per dimension, each instance's W and c as
its data) and reference problem 5.

    python -m pyipm_tpu_torch.examples.heterogeneous_fleet [--device cpu]
"""

import argparse

import numpy as np
import torch

from pyipm_tpu_torch import IPMConfig, Problem, solve_fleet
from pyipm_tpu_torch.models.reference_problems import get_problem


def box_qp_problem(nvar):
    """min 0.5 x'Wx + c'x  s.t.  -1 <= x <= 1, with (W, c) as data."""
    return Problem(
        f=lambda x, p: 0.5 * x @ (p[0] @ x) + p[1] @ x,
        ci=lambda x, p: torch.cat([x + 1.0, 1.0 - x]),
        nvar=nvar, nineq=2 * nvar)


def box_qp_data(nvar, seed):
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(nvar, nvar))
    return (G @ G.T / nvar + np.eye(nvar), rng.normal(size=nvar))


def main(device="cuda"):
    problems, x0s, params = [], [], []
    qp2, qp4 = box_qp_problem(2), box_qp_problem(4)
    for i in range(6):
        problems.append(qp2)
        x0s.append(np.zeros(2))
        params.append(box_qp_data(2, i))
    for i in range(5):
        problems.append(qp4)
        x0s.append(np.zeros(4))
        params.append(box_qp_data(4, 10 + i))
    problems.append(get_problem(5).make())
    x0s.append(np.zeros(2))
    params.append(())

    results = solve_fleet(problems, x0s, IPMConfig(verbosity=0),
                          params=params, device=device)
    for i, r in enumerate(results):
        print(f"instance {i:2d}: D={r.x.shape[0]} signal={int(r.signal)} "
              f"f={float(r.fval):+.4f}")
    assert all(int(r.signal) in (1, 2) for r in results)
    # the reference-problem instance lands on its known optimum (4, 3)
    assert np.allclose(results[-1].x.cpu().numpy(), [4.0, 3.0], atol=1e-3)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    main(ap.parse_args().device)
