"""Checkpoint and resume of the solver state (counterpart of
``pyipm_tpu/utils/checkpoint.py``).

A :class:`~pyipm_tpu_torch.core.solver.SolverState` (or a
``SolverResult``), batched, is the checkpoint unit: save it after
``run_budget`` pauses a solve, restore it on the card (or anywhere), and
finish it with ``run``.  The format is one ``.npz``: the tensors in field
order, nested NamedTuples flattened in place, each stored under its dotted
field path; ``None`` fields (the L-BFGS memory of an exact-Hessian solve,
the history of a solve without ``trace_metrics``) hold no entry.  The
JAX package's orbax backend is JAX-only and is not ported.

A file that does not match the structure it is restored into raises
:class:`CheckpointError`: a different leaf count (``trace_metrics`` on
against off, L-BFGS against exact Hessian), other field paths, or another
shape (problem size, batch size).
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch


class CheckpointError(RuntimeError):
    """A checkpoint file does not match the expected state structure."""


def _leaves(tree, prefix=""):
    """(dotted path, tensor) of every tensor of a nested NamedTuple, in
    field order; None fields are skipped."""
    out = []
    for k, v in tree._asdict().items():
        if v is None:
            continue
        if isinstance(v, tuple):
            out += _leaves(v, f"{prefix}{k}.")
        else:
            out.append((f"{prefix}{k}", v))
    return out


def _rebuild(like, it):
    """``like`` with each tensor replaced, in field order, from ``it``."""
    return type(like)(*(
        None if v is None
        else _rebuild(v, it) if isinstance(v, tuple)
        else next(it)
        for v in like))


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_state(path: str, state: Any) -> None:
    """Write ``state`` (a SolverState or SolverResult, batched or not) to
    ``path`` (``.npz`` appended if missing)."""
    np.savez(_npz_path(path), **{k: v.detach().cpu().numpy()
                                 for k, v in _leaves(state)})


def restore_state(path: str, like: Any) -> Any:
    """Restore what :func:`save_state` wrote, into the structure of
    ``like`` (e.g. a fresh ``init_state``), every tensor on ``like``'s
    device and in its dtype.  Raises :class:`CheckpointError` when the
    file is missing or does not match ``like``."""
    npz = _npz_path(path)
    if not os.path.exists(npz):
        raise CheckpointError(f"no checkpoint at {path!r}: {npz!r} does "
                              f"not exist")
    want = _leaves(like)
    with np.load(npz) as data:
        names = list(data.files)
        if len(names) != len(want):
            raise CheckpointError(
                f"checkpoint {npz!r} holds {len(names)} leaves but the "
                f"expected state has {len(want)} (saved with another "
                f"trace_metrics or L-BFGS setting, or another state type?)")
        if names != [k for k, _ in want]:
            raise CheckpointError(
                f"checkpoint {npz!r} leaves {names} are not the expected "
                f"{[k for k, _ in want]}")
        leaves = []
        for k, ref in want:
            arr = data[k]
            if tuple(arr.shape) != tuple(ref.shape):
                raise CheckpointError(
                    f"checkpoint {npz!r} leaf {k}: shape {tuple(arr.shape)}"
                    f" != expected {tuple(ref.shape)} (another problem, "
                    f"batch or solver configuration?)")
            leaves.append(torch.as_tensor(arr).to(device=ref.device,
                                                  dtype=ref.dtype))
    return _rebuild(like, iter(leaves))
