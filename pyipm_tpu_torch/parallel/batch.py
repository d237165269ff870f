"""Lockstep batching of many independent instances on one device
(counterpart of ``make_batch_solver`` / ``solve_batch`` in
``pyipm_tpu/parallel/batch.py``).

The port's solver core is batch first already (and prints nothing), so
the lockstep batch solver IS the core solver.  Wave compaction,
``rescue_failures`` and mesh sharding are not ported yet.
"""

from __future__ import annotations

from typing import Optional

from pyipm_tpu_torch.config import IPMConfig
from pyipm_tpu_torch.core.problem import Problem
from pyipm_tpu_torch.core.solver import BatchSolver, SolverResult


def make_batch_solver(problem: Problem,
                      config: Optional[IPMConfig] = None) -> BatchSolver:
    """``fn(x0_batch, params=(), s0=None, lda0=None) -> SolverResult`` with
    a leading batch axis on every input and output; runs on the device of
    ``x0_batch``."""
    return BatchSolver(problem, config)


def solve_batch(problem: Problem, x0_batch,
                config: Optional[IPMConfig] = None, s0=None, lda0=None,
                params=()) -> SolverResult:
    """One-shot batched solve over the leading axis of ``x0_batch``;
    ``params`` holds the per-instance data (leading batch axis)."""
    return make_batch_solver(problem, config)(x0_batch, params, s0, lda0)
