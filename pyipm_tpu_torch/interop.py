"""Carry the JAX package's objects across to the port, as numpy.

This module never imports jax: it takes what the JAX side hands over as
numpy arrays or plain dicts (``np.asarray`` of a ``QPData`` field,
``dataclasses.asdict`` of an ``IPMConfig``) and returns the port's objects
on a chosen device, and turns the port's results back into numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from pyipm_tpu_torch.config import IPMConfig
from pyipm_tpu_torch.core.lbfgs import LBFGSState
from pyipm_tpu_torch.core.solver import (
    MetricsHistory, SolverResult, SolverState,
)
from pyipm_tpu_torch.models import applications as app
from pyipm_tpu_torch.models.random_nlp import (
    DenseNLPData, QPData, dense_nlp_data, qp_data, resolve_device,
)
from pyipm_tpu_torch.models.reference_problems import (
    REFERENCE_PROBLEMS, ReferenceProblem,
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


def portfolio_data_from_numpy(data, device=None,
                              dtype=None) -> app.PortfolioData:
    """A PortfolioData (either package's, or a dict keyed by field name)
    as the port's, on ``device`` (the card when None)."""
    return app.portfolio_data(_as_arrays(data, app.PortfolioData._fields),
                              device=device, dtype=dtype)


def svm_data_from_numpy(data, device=None, dtype=None) -> app.SVMData:
    return app.svm_data(_as_arrays(data, app.SVMData._fields),
                        device=device, dtype=dtype)


def maxent_data_from_numpy(data, device=None, dtype=None) -> app.MaxEntData:
    return app.maxent_data(_as_arrays(data, app.MaxEntData._fields),
                           device=device, dtype=dtype)


def mpc_data_from_numpy(data, device=None, dtype=None) -> app.MPCData:
    return app.mpc_data(_as_arrays(data, app.MPCData._fields),
                        device=device, dtype=dtype)


def config_from_dict(d: dict) -> IPMConfig:
    """The port's IPMConfig from ``dataclasses.asdict`` of a JAX one."""
    return IPMConfig.from_dict(dict(d))


def result_to_numpy(res: SolverResult) -> dict:
    """A SolverResult as a dict of numpy arrays keyed by field name (its
    ``hist`` a dict of the same kind)."""
    def conv(v):
        if isinstance(v, tuple):
            return {k: conv(u) for k, u in v._asdict().items()}
        return v.detach().cpu().numpy()
    return conv(res)


def lbfgs_state_from_numpy(state, device=None, dtype=None) -> LBFGSState:
    """An L-BFGS memory (the JAX package's ``LBFGSState`` of one instance,
    S (D, m), or of a batch, S (B, D, m), or a dict keyed by field name)
    as the port's batch-first LBFGSState on ``device`` (the card when
    None): zeta, S and Y in ``dtype`` (theirs when None), count and fail
    int32."""
    arr = _as_arrays(state, LBFGSState._fields)
    if arr["S"].ndim == 2:
        arr = {k: v[None] for k, v in arr.items()}
    dev = resolve_device(device)

    def t(k, dt):
        return torch.tensor(arr[k], device=dev, dtype=dt)

    fdt = dtype if dtype is not None else t("S", None).dtype
    return LBFGSState(zeta=t("zeta", fdt).reshape(-1), S=t("S", fdt),
                      Y=t("Y", fdt), count=t("count", torch.int32).reshape(-1),
                      fail=t("fail", torch.int32).reshape(-1))


def reference_problem(key) -> ReferenceProblem:
    """The port's reference problem for a number (1 to 10) or for the JAX
    package's spec of it (matched by name)."""
    if isinstance(key, int):
        return REFERENCE_PROBLEMS[key]
    for spec in REFERENCE_PROBLEMS.values():
        if spec.name == key.name:
            return spec
    raise KeyError(f"no reference problem named {key.name!r}")


def solver_state_from_numpy(state, device=None, dtype=None) -> SolverState:
    """The JAX package's ``SolverState`` (of one instance, or batched by
    vmap) as the port's batch-first one on ``device`` (the card when None),
    floating fields in ``dtype`` (theirs when None), counters int32, loop
    flags bool.  The JAX state always carries the L-BFGS memory and the
    history; they map across where its configuration used them (memory
    width and T above 0) and are None otherwise, as the port's state of
    the same configuration holds them."""
    fields = {k: getattr(state, k) for k in state._fields}
    one = np.ndim(fields["x"]) == 1
    dev = resolve_device(device)

    def t(v, dt=None):
        a = np.asarray(v)
        out = torch.tensor(a[None] if one else a, device=dev)
        if dt is None and out.is_floating_point():
            dt = dtype
        return out if dt is None else out.to(dt)

    kinds = dict.fromkeys(("signal", "iter_count", "outer", "inner",
                           "reg_retries"), torch.int32)
    kinds.update(inner_done=torch.bool, in_inner=torch.bool)
    kw = {k: t(fields[k], kinds.get(k)) for k in SolverState._fields
          if k not in ("lbfgs", "x_old", "g", "hist")}
    mem = fields["lbfgs"]
    if np.shape(mem.S)[-1] > 0:
        kw["lbfgs"] = lbfgs_state_from_numpy(mem, device=dev,
                                             dtype=kw["x"].dtype)
        kw["x_old"], kw["g"] = t(fields["x_old"]), t(fields["g"])
    hist = fields["hist"]
    if np.shape(hist.mu)[-1] > 0:
        kw["hist"] = MetricsHistory(*(t(getattr(hist, k))
                                      for k in MetricsHistory._fields))
    return SolverState(**kw)
