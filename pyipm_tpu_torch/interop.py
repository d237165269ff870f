"""Carry the JAX package's objects across to the port, as numpy.

This module never imports jax: it takes what the JAX side hands over as
numpy arrays or plain dicts (``np.asarray`` of a ``QPData`` field,
``dataclasses.asdict`` of an ``IPMConfig``) and returns the port's objects
on a chosen device, and turns the port's results back into numpy.
"""

from __future__ import annotations

import numpy as np

from pyipm_tpu_torch.config import IPMConfig
from pyipm_tpu_torch.core.solver import SolverResult
from pyipm_tpu_torch.models.random_nlp import (
    DenseNLPData, QPData, dense_nlp_data, qp_data,
)


def _as_arrays(data, fields) -> dict:
    if not isinstance(data, dict):
        data = {k: getattr(data, k) for k in fields}
    return {k: np.asarray(v) for k, v in data.items()}


def qpdata_from_numpy(data, device=None, dtype=None) -> QPData:
    """A QPData (from either package, or a dict keyed by field name) whose
    leaves convert with ``np.asarray``, as the port's QPData on
    ``device`` (the card when None; pass ``device="cpu"`` for the CPU)."""
    return qp_data(_as_arrays(data, QPData._fields), device=device,
                   dtype=dtype)


def dense_from_numpy(data, device=None, dtype=None) -> DenseNLPData:
    """A DenseNLPData (the JAX package's, or a dict keyed by field name)
    as the port's, on ``device`` (the card when None)."""
    return dense_nlp_data(_as_arrays(data, DenseNLPData._fields),
                          device=device, dtype=dtype)


def config_from_dict(d: dict) -> IPMConfig:
    """The port's IPMConfig from ``dataclasses.asdict`` of a JAX one."""
    return IPMConfig.from_dict(dict(d))


def result_to_numpy(res: SolverResult) -> dict:
    """A SolverResult as a dict of numpy arrays, keyed by field name."""
    return {k: v.detach().cpu().numpy() for k, v in res._asdict().items()}
