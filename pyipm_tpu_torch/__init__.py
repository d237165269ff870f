"""pyipm_tpu_torch — the PyTorch/CUDA port of pyipm_tpu for the H100.

The same line-search primal-dual interior-point method as ``pyipm_tpu``,
batch first on PyTorch tensors, with hand-written Hopper kernels for the
batched small LDL^T factorization and solve (``csrc/small_ldlt.cu``) and,
for KKT systems above 128 and the Schur solver's large blocks, the panel
LDL^T of the blocked factorization (``csrc/panel_ldlt.cu``) and the backward sweeps
(``csrc/bwd_sweep_panels.cu``, ``csrc/bwd_sweep_blocks.cu``).
Imports torch and never jax.

Public API:
  - `IPM` — the reference's class facade (``python -m pyipm_tpu_torch``
    drives it on the ten example problems).
  - `REFERENCE_PROBLEMS`, `get_problem` — those ten problems.
  - `IPMConfig` — solver hyperparameters (same fields as pyipm_tpu's).
  - `Problem`, `make_problem` — per-instance callables ``(x, p)``.
  - `make_solver`, `solve` — batch-first solver; single-instance solve.
  - `solve_batch`, `make_batch_solver` — lockstep fleet solve.
  - `make_wave_batch_solver` — a fleet that retires converged instances
    in waves; `rescue_failures` — re-solve a fleet's failures;
    `solve_fleet` — mixed problems and shapes in one call.
  - `BlockNLP`, `make_block_solver` — one large block-separable NLP,
    its blocks split over the ranks of a process mesh (bordered Schur
    complement; ``parallel/schur.py``, ``parallel/launch.py``).
  - `MetricsHistory` — per-iteration histories (``trace_metrics``);
    ``utils.profiling`` and ``utils.checkpoint`` — scopes, traces,
    timings, and pause/save/restore/resume of a solve.
"""

from pyipm_tpu_torch.api import IPM
from pyipm_tpu_torch.config import IPMConfig
from pyipm_tpu_torch.core.problem import Problem, make_problem
from pyipm_tpu_torch.core.solver import (
    MetricsHistory, SolverResult, SolverState, make_solver, solve,
)
from pyipm_tpu_torch.models.reference_problems import (
    REFERENCE_PROBLEMS, get_problem,
)
from pyipm_tpu_torch.parallel.batch import (
    make_batch_solver, make_wave_batch_solver, rescue_failures, solve_batch,
)
from pyipm_tpu_torch.parallel.fleet import solve_fleet
from pyipm_tpu_torch.parallel.schur import BlockNLP, make_block_solver

__version__ = "0.1.0"

__all__ = [
    "IPM",
    "REFERENCE_PROBLEMS",
    "get_problem",
    "IPMConfig",
    "Problem",
    "make_problem",
    "SolverState",
    "SolverResult",
    "MetricsHistory",
    "make_solver",
    "solve",
    "make_batch_solver",
    "solve_batch",
    "make_wave_batch_solver",
    "rescue_failures",
    "solve_fleet",
    "BlockNLP",
    "make_block_solver",
]
