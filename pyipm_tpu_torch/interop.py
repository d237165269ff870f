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
from pyipm_tpu_torch.parallel import schur as _schur


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


# ----------------------------------------------------------------------
# the block-separable Schur solver's data and state
def _tree_to(tree, dev, dtype):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev, dtype) for k, v in tree.items()}
    out = torch.tensor(np.asarray(tree), device=dev)
    return out.to(dtype) if (dtype is not None
                             and out.is_floating_point()) else out


def block_data_from_numpy(theta, ccdata=None, device=None, dtype=None):
    """A block NLP's theta and ccdata (the JAX package's dicts of arrays,
    nested or not) as the port's dicts of tensors on ``device`` (the card
    when None); floating arrays in ``dtype`` (theirs when None).  Returns
    (theta, ccdata)."""
    dev = resolve_device(device)
    return (_tree_to(dict(theta), dev, dtype),
            _tree_to(dict(ccdata), dev, dtype) if ccdata is not None
            else None)


def separable_data_from_numpy(data, device=None,
                              dtype=None) -> "_schur.SeparableData":
    """A JAX ``SeparableData`` (or a dict keyed by field name) as the
    port's on ``device`` (the card when None)."""
    if not isinstance(data, dict):
        data = {k: getattr(data, k) for k in _schur.SeparableData._fields}
    dev = resolve_device(device)
    return _schur.SeparableData(**{k: _tree_to(v, dev, dtype)
                                   for k, v in data.items()})


def resource_alloc_from_numpy(data, device=None,
                              dtype=None) -> app.ResourceAllocData:
    """A JAX ``ResourceAllocData`` (theta, ccdata) as the port's on
    ``device`` (the card when None)."""
    return app.resource_alloc_data(dict(data[0]), dict(data[1]),
                                   device=device, dtype=dtype)


def block_state_from_numpy(state, device=None, dtype=None) -> SolverState:
    """A JAX block solver's ``SolverState`` (``fn.init_state`` or
    ``fn.run_budget`` of ``make_block_solver``, every block) as the
    port's block state on ``device`` (the card when None) for a solve in
    ONE process: x, delta and the block multipliers are (K, ...) slabs,
    the loop fields a batch of one, ``s`` the (s, sc) pair and ``lda``
    (le, li, lc, lci); the centrality lanes ``g``, the history and an
    L-BFGS solve's per-block memory and ``x_old`` map across where the
    JAX state holds them (None otherwise)."""
    dev = resolve_device(device)

    def t(v, dt=None):
        out = torch.tensor(np.asarray(v), device=dev)
        if dt is None and out.is_floating_point():
            dt = dtype
        return out if dt is None else out.to(dt)

    def one(v, dt=None):
        return t(v, dt).reshape(1)

    ints = dict.fromkeys(("signal", "iter_count", "outer", "inner",
                          "reg_retries"), torch.int32)
    ints.update(inner_done=torch.bool, in_inner=torch.bool)
    kw = {k: one(getattr(state, k), ints.get(k))
          for k in ("mu", "nu", "signal", "iter_count", "outer", "inner",
                    "inner_done", "in_inner", "f_past", "alpha",
                    "reg_retries")}
    g = np.asarray(state.g)
    hist = state.hist
    # exact-Hessian mode holds an empty memory and a (0,) x_old
    lbfgs = np.asarray(state.x_old).size > 0
    return SolverState(
        x=t(state.x), s=tuple(t(v) for v in state.s),
        lda=tuple(t(v) for v in state.lda), delta=t(state.delta),
        kkt=t(state.kkt)[None], g=t(g)[None] if g.size else None,
        lbfgs=(lbfgs_state_from_numpy(state.lbfgs, device=dev, dtype=dtype)
               if lbfgs else None),
        x_old=t(state.x_old) if lbfgs else None,
        hist=(MetricsHistory(*(t(getattr(hist, k))[None]
                               for k in MetricsHistory._fields))
              if np.shape(hist.mu)[-1] > 0 else None),
        **kw)

