"""Fleets of independent instances on one device (counterpart of
``pyipm_tpu/parallel/batch.py``): lockstep, wave-compacted, and the rescue
of the failures.

The port's solver core is batch first already (and prints nothing), so
the lockstep batch solver IS the core solver.  :func:`make_wave_batch_solver`
uses the core's pause and resume (``BatchSolver.run_budget``) to retire
converged instances: a first wave over the whole batch, then waves over
the instances still running only, gathered into a compact state.  The
JAX package pads each wave to a power-of-two bucket (``min_pad``) so that
XLA compiles few shapes; PyTorch compiles nothing per shape, so a wave
here is exactly the active set.  :func:`rescue_failures` re-solves the
instances a run did not converge under a stronger configuration and
merges the successes back.

With a mesh (``parallel/mesh.py``), :func:`make_batch_solver` splits a
fleet over the ranks of the mesh's ``batch`` dimension: each rank solves
its ``host_local_slice`` with no collective, and the result is gathered
onto every rank at the end.
"""

from __future__ import annotations

from typing import Optional

import torch

from pyipm_tpu_torch import _sync
from pyipm_tpu_torch.config import IPMConfig
from pyipm_tpu_torch.core.linesearch import take
from pyipm_tpu_torch.core.problem import Problem
from pyipm_tpu_torch.core.solver import (
    BatchSolver, SolverResult, _put, _rows, _tree,
)


class ShardedBatchSolver(BatchSolver):
    """A :class:`BatchSolver` whose call solves this rank's slice of the
    global batch and gathers every rank's result (the JAX package's
    ``make_batch_solver(mesh=...)``, batch.py:42-75)."""

    def __init__(self, problem: Problem, config: Optional[IPMConfig],
                 mesh, batch_axis: str = "batch"):
        super().__init__(problem, config)
        self.mesh, self.batch_axis = mesh, batch_axis

    def __call__(self, x0, params=(), s0=None, lda0=None, mu0=None,
                 nu0=None) -> SolverResult:
        from pyipm_tpu_torch.parallel.distributed import host_local_slice
        import torch.distributed as dist

        sl = host_local_slice(x0.shape[0], self.mesh, self.batch_axis)
        ids = torch.arange(sl.start, sl.stop, device=x0.device)

        def part(v):
            return None if v is None else v[sl]

        def part_warm(v):                  # a number, or (B,) per instance
            return v[sl] if torch.is_tensor(v) and v.ndim else v

        res = super().__call__(x0[sl], take(params, ids), part(s0),
                               part(lda0), part_warm(mu0), part_warm(nu0))
        group = self.mesh.get_group(self.batch_axis)
        n = dist.get_world_size(group)

        def gather(t):
            if t.numel() == 0:             # (B, 0) histories: no exchange
                return t.new_empty((t.shape[0] * n,) + t.shape[1:])
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t.contiguous(), group=group)
            return torch.cat(parts, dim=0)

        return _tree(gather, res)


def make_batch_solver(problem: Problem, config: Optional[IPMConfig] = None,
                      mesh=None, batch_axis: str = "batch") -> BatchSolver:
    """``fn(x0_batch, params=(), s0=None, lda0=None, mu0=None, nu0=None)
    -> SolverResult`` with a leading batch axis on every input and output
    (``mu0``/``nu0`` a number or a (B,) tensor); runs on the device of
    ``x0_batch``.  With ``mesh`` each rank of its ``batch_axis`` solves
    its slice of the (global, every rank's) batch, and the result comes
    back whole on every rank."""
    if mesh is None:
        return BatchSolver(problem, config)
    return ShardedBatchSolver(problem, config, mesh, batch_axis)


def solve_batch(problem: Problem, x0_batch,
                config: Optional[IPMConfig] = None, s0=None, lda0=None,
                params=()) -> SolverResult:
    """One-shot batched solve over the leading axis of ``x0_batch``;
    ``params`` holds the per-instance data (leading batch axis)."""
    return make_batch_solver(problem, config)(x0_batch, params, s0, lda0)


def make_wave_batch_solver(problem: Problem,
                           config: Optional[IPMConfig] = None, *,
                           first_wave: int = 16, wave: int = 32,
                           wave_growth: float = 1.0, max_wave: int = 512,
                           max_waves: int = 1000):
    """Batched solver that retires converged instances in waves.

    Returns ``fn(x0_batch, params=()) -> SolverResult``, per instance the
    solve of the lockstep :func:`make_batch_solver`: every instance runs
    ``first_wave`` inner iterations, then the instances still running are
    gathered (in their original order) into a compact state, advanced by
    ``wave`` more, and scattered back, until none runs; one host sync per
    wave reads the active set.  ``wave_growth`` > 1 grows the budget
    geometrically up to ``max_wave`` (a larger ``wave`` is never cut);
    after ``max_waves`` waves the remainder runs to its end."""
    solver = BatchSolver(problem, config)
    cfg = solver.config

    def fn(x0_batch, params=()) -> SolverResult:
        st = solver.init_state(x0_batch, params)
        st = solver.run_budget(st, first_wave, params)
        _sync.COUNTS["waves"] += 1
        budget = float(wave)
        for _ in range(max_waves):
            ids = _sync.indices((st.signal == 0) & (st.outer < cfg.niter))
            if ids.numel() == 0:
                return solver.finalize(st, params)
            _sync.COUNTS["waves"] += 1
            sub = solver.run_budget(_rows(st, ids), int(budget),
                                    take(params, ids))
            st = _put(st, ids, sub)
            budget = min(budget * wave_growth, float(max(max_wave, wave)))
        return solver.finalize(solver.run(st, params), params)

    return fn


def rescue_failures(result: SolverResult, x0_batch, config: IPMConfig,
                    problem: Problem, params=(),
                    rescue_config: Optional[IPMConfig] = None):
    """Re-solve, cold from ``x0_batch``, the instances of ``result`` that
    did not converge (signal not 1 or 2) under ``rescue_config`` (by
    default ``config`` with ``mu_strategy='auto'`` and three times the
    outer budget), and merge back only the rescues that converged: a
    failed rescue keeps its original result, a converged instance is not
    touched.  ``params`` is the batch's per-instance data.  Returns
    ``(merged, n_failed, n_rescued)``."""
    ok0 = (result.signal == 1) | (result.signal == 2)
    ids = _sync.indices(~ok0)
    n_failed = int(ids.numel())
    if n_failed == 0:
        return result, 0, 0
    rcfg = (rescue_config if rescue_config is not None
            else config.replace(mu_strategy="auto", niter=3 * config.niter))
    rres = BatchSolver(problem, rcfg)(x0_batch[ids], take(params, ids))
    ok = (rres.signal == 1) | (rres.signal == 2)

    def merge(a, b):
        if a.shape[1:] != b.shape[1:]:
            # histories of another length (a larger budget): keep a's
            return a
        mask = ok.view((-1,) + (1,) * (b.dim() - 1))
        return a.index_copy(0, ids, torch.where(mask, b, a[ids]))

    merged = _tree(merge, result, rres)
    return merged, n_failed, int(ok.sum())
