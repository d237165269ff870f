"""Reference example problems (counterpart of
``pyipm_tpu/models/reference_problems.py``).  Only example 7 is ported so
far; it is the reference's published transcript (pyipm.py:2043-2064)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from pyipm_tpu_torch.core.problem import Problem, make_problem


@dataclasses.dataclass(frozen=True)
class ReferenceProblem:
    name: str
    description: str
    nvar: int
    f: Callable
    ce: Optional[Callable]
    ci: Optional[Callable]
    ground_truth: Sequence[Sequence[float]]
    sample_x0: Callable                        # numpy rng -> x0

    def make(self) -> Problem:
        return make_problem(self.f, self.nvar, ce=self.ce, ci=self.ci)

    def distance_to_truth(self, x) -> float:
        x = np.asarray(x)
        return min(float(np.linalg.norm(x - np.asarray(gt)))
                   for gt in self.ground_truth)


def _p7_f(x, p):
    return -x[0] * x[1] * x[2]


def _p7_ce(x, p):
    return torch.sum(x) - 1.0


def _p7_ci(x, p):
    return 1.0 * x


REFERENCE_PROBLEMS = {
    7: ReferenceProblem(
        "p7_maxprod",
        "max xyz s.t. x+y+z=1, x,y,z>=0 (pyipm.py:2043-2064)",
        3, _p7_f, _p7_ce, _p7_ci, [[1.0 / 3.0] * 3],
        lambda rng: rng.standard_normal(3)),
}
