"""Heterogeneous fleets: many problems of mixed shapes and families in one
call (counterpart of ``pyipm_tpu/parallel/fleet.py``).

:func:`solve_fleet` takes one :class:`Problem` and one start per instance,
with each instance's data as ``params``, and batches all it can:

1. **Bucketing.**  Instances share a bucket when they share the Problem
   OBJECT, its (D, M, N), and the shape and dtype of every param tensor.
   A family is one Problem whose callables read their instance's data
   from ``params`` (as ``make_qp_problem`` and the application families
   do), so a fleet of one family is one bucket per shape.  The JAX
   package instead traces every callable to a jaxpr and keys on its text,
   lifting closed-over arrays out as data; torch has no jaxpr, so that
   closure lifting is not ported, and distinct Problem objects never share
   a bucket (which splits work and never changes a result).
2. **Batched dispatch.**  A bucket of at least ``min_batch`` instances
   runs through the wave-compacted solver (:mod:`.batch`) with the
   instances' params stacked on a new leading axis; a smaller bucket runs
   each instance as a batch of one.
3. **Reassembly.**  The results come back as one unbatched
   :class:`SolverResult` per instance, in the original order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from pyipm_tpu_torch.config import IPMConfig
from pyipm_tpu_torch.core.problem import Problem
from pyipm_tpu_torch.core.solver import BatchSolver, SolverResult, _tree
from pyipm_tpu_torch.models.random_nlp import resolve_device
from pyipm_tpu_torch.parallel.batch import make_wave_batch_solver


def _as_params(p, device, dtype):
    """One instance's params as tensors on ``device``; floating leaves in
    ``dtype``."""
    def conv(v):
        t = torch.as_tensor(v, device=device)
        return t.to(dtype) if t.is_floating_point() else t
    leaves = tuple(conv(v) for v in p)
    return type(p)(*leaves) if hasattr(p, "_fields") else leaves


def _stack(ps):
    leaves = tuple(torch.stack(col) for col in zip(*ps))
    return type(ps[0])(*leaves) if hasattr(ps[0], "_fields") else leaves


def bucket_key(problem: Problem, params=()):
    """The key :func:`solve_fleet` groups an instance by."""
    return (id(problem), problem.nvar, problem.neq, problem.nineq,
            type(params),
            tuple((tuple(t.shape), t.dtype) for t in params))


def solve_fleet(problems: Sequence[Problem], x0s: Sequence,
                config: Optional[IPMConfig] = None, *, params=None,
                device=None, first_wave: int = 16, wave: int = 32,
                min_batch: int = 2) -> List[SolverResult]:
    """Solve a fleet of mixed problems, batching all batchable work.

    Args:
      problems: one :class:`Problem` per instance (shapes and callables may
        differ across instances).
      x0s: per-instance starts, ``x0s[i]`` of shape ``(problems[i].nvar,)``
        (tensors or arrays).
      config: one configuration for the whole fleet.
      params: per-instance data, ``params[i]`` a tuple or NamedTuple of
        that instance's tensors (no batch axis); None for none.
      device: where the fleet runs (the card when None).
      first_wave / wave: the wave budgets of batched buckets
        (:func:`~pyipm_tpu_torch.parallel.batch.make_wave_batch_solver`).
      min_batch: buckets smaller than this run instance by instance.

    Returns ``list[SolverResult]`` in the original instance order, each
    without a batch axis."""
    cfg = config if config is not None else IPMConfig()
    n = len(problems)
    if len(x0s) != n or (params is not None and len(params) != n):
        raise ValueError("one x0 (and one params entry) per problem")
    dev = resolve_device(device)
    dtype = cfg.torch_dtype
    ps = [_as_params(() if params is None else params[i], dev, dtype)
          for i in range(n)]
    buckets = {}
    for i, (prob, p) in enumerate(zip(problems, ps)):
        buckets.setdefault(bucket_key(prob, p), []).append(i)

    results: List[Optional[SolverResult]] = [None] * n
    for idx in buckets.values():
        prob = problems[idx[0]]
        x0b = torch.stack([torch.as_tensor(x0s[i], device=dev).to(dtype)
                           .reshape(prob.nvar) for i in idx])
        if len(idx) < min_batch:
            solver = BatchSolver(prob, cfg)
            for k, i in enumerate(idx):
                p1 = _stack([ps[i]])
                res = solver(x0b[k:k + 1], p1)
                results[i] = _tree(lambda t: t[0], res)
            continue
        fn = make_wave_batch_solver(prob, cfg, first_wave=first_wave,
                                    wave=wave)
        res = fn(x0b, _stack([ps[i] for i in idx]))
        for k, i in enumerate(idx):
            results[i] = _tree(lambda t, k=k: t[k], res)
    return results
