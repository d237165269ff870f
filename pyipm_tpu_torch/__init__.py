"""pyipm_tpu_torch — the PyTorch/CUDA port of pyipm_tpu for the H100.

The same line-search primal-dual interior-point method as ``pyipm_tpu``,
batch first on PyTorch tensors, with hand-written Hopper kernels for the
batched small LDL^T factorization and solve (``csrc/small_ldlt.cu``) and,
for KKT systems above 128, the panel LDL^T of the blocked factorization
(``csrc/panel_ldlt.cu``) and the backward sweeps
(``csrc/bwd_sweep_panels.cu``, ``csrc/bwd_sweep_blocks.cu``).
Imports torch and never jax.

Public API:
  - `IPMConfig` — solver hyperparameters (same fields as pyipm_tpu's).
  - `Problem`, `make_problem` — per-instance callables ``(x, p)``.
  - `make_solver`, `solve` — batch-first solver; single-instance solve.
  - `solve_batch`, `make_batch_solver` — lockstep fleet solve.
"""

from pyipm_tpu_torch.config import IPMConfig
from pyipm_tpu_torch.core.problem import Problem, make_problem
from pyipm_tpu_torch.core.solver import (
    SolverResult, SolverState, make_solver, solve,
)
from pyipm_tpu_torch.parallel.batch import make_batch_solver, solve_batch

__version__ = "0.1.0"

__all__ = [
    "IPMConfig",
    "Problem",
    "make_problem",
    "SolverState",
    "SolverResult",
    "make_solver",
    "solve",
    "make_batch_solver",
    "solve_batch",
]
