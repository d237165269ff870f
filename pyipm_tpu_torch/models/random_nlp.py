"""The random QP family of the fleet benchmark (counterpart of the QP half
of ``pyipm_tpu/models/random_nlp.py``).

Instance data is drawn with numpy from a seed, with the same distributions
as the JAX package's ``sample_qp_batch`` (random_nlp.py:45-58).  The two
packages' generators give different numbers, so a parity test draws the
data once with numpy and hands the same arrays to both.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pyipm_tpu_torch.core.problem import Problem


class QPData(NamedTuple):
    """Random inequality-constrained QP instances, leading axis = instance:

        min 0.5 x'Qx + c'x   s.t.   x - lb >= 0,  ub - x >= 0,  Ax - b >= 0

    Q is symmetric positive definite; x = 0 is strictly feasible."""
    Q: torch.Tensor       # (B, D, D)
    c: torch.Tensor       # (B, D)
    A: torch.Tensor       # (B, L, D)
    b: torch.Tensor       # (B, L)
    lb: torch.Tensor      # (B, D)
    ub: torch.Tensor      # (B, D)


def sample_qp_arrays(seed: int, B: int, D: int, nlin: int = 4,
                     dtype=np.float32) -> dict:
    """numpy arrays of a QP batch, keyed by QPData field."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, D, D))
    Q = np.einsum("bij,bkj->bik", G, G) / D + np.eye(D)[None]
    out = dict(
        Q=Q,
        c=rng.standard_normal((B, D)),
        A=rng.standard_normal((B, nlin, D)),
        b=-(np.abs(rng.standard_normal((B, nlin))) + 0.1),
        lb=-(np.abs(rng.standard_normal((B, D))) + 0.5),
        ub=np.abs(rng.standard_normal((B, D))) + 0.5,
    )
    return {k: v.astype(dtype) for k, v in out.items()}


def qp_data(arrays: dict, device="cpu", dtype=None) -> QPData:
    """QPData from numpy arrays keyed by field name."""
    return QPData(*(torch.tensor(np.asarray(arrays[k]), device=device,
                                    dtype=dtype)
                    for k in QPData._fields))


def sample_qp_batch(seed: int, B: int, D: int, nlin: int = 4, *,
                    dtype="float32", device="cpu") -> QPData:
    """A seeded batch of B random QPs with D variables and nlin linear
    inequalities (2D + nlin inequalities in all)."""
    return qp_data(sample_qp_arrays(seed, B, D, nlin, np.dtype(dtype)),
                   device=device)


def make_qp_problem(nvar: int, nlin: int) -> Problem:
    """The QP family as one Problem whose callables read their instance's
    data from ``p`` (a QPData row)."""

    def f(x, p):
        return 0.5 * x @ (p.Q @ x) + p.c @ x

    def ci(x, p):
        return torch.cat([x - p.lb, p.ub - x, p.A @ x - p.b])

    return Problem(f=f, nvar=nvar, nineq=2 * nvar + nlin, ci=ci)
