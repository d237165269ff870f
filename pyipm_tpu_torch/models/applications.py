"""Application model families (counterpart of
``pyipm_tpu/models/applications.py``): canonical constrained workloads.

Each family follows ``models/random_nlp.py``: a NamedTuple of instance
data (leading axis = instance), ``sample_*_arrays`` drawing it with numpy
from a seed (the JAX package's distributions; the two packages'
generators differ, so a parity test draws once and hands the same arrays
to both), ``*_data`` putting it on a device (the card when None),
``make_*_problem`` returning ONE :class:`Problem` whose ``(x, p)``
callables read their instance's data from ``p``, a start ``*_x0``, and
``make_*_batch_solver``.

Families:
  - **Markowitz portfolio**: min risk - return on a capped simplex
    (equality + inequalities);
  - **SVM dual**: box-constrained QP with one equality;
  - **Maximum entropy**: max H(p) on the simplex under moment constraints
    (reference example 6 at scale, pyipm.py:2019-2042);
  - **MPC**: finite-horizon tracking with input bounds, condensed to the
    input sequence; the rollout is a loop over the horizon inside the
    objective, differentiated by ``torch.func``.

The resource-allocation family of the JAX package is a ``BlockNLP`` of
the distributed Schur solver and waits for it (ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pyipm_tpu_torch.config import IPMConfig
from pyipm_tpu_torch.core.problem import Problem
from pyipm_tpu_torch.core.solver import BatchSolver
from pyipm_tpu_torch.models.random_nlp import _tensors, resolve_device


def _cast(arrays: dict, dtype) -> dict:
    return {k: np.asarray(v, dtype=dtype) for k, v in arrays.items()}


def _full(batch, n, value, dtype, device):
    return torch.full((batch, n), value, dtype=getattr(torch, np.dtype(
        dtype).name), device=resolve_device(device))


# ----------------------------------------------------------------------
# Markowitz portfolio:  min x'Sx - gamma m'x   s.t. sum(x) = 1, 0 <= x <= cap
class PortfolioData(NamedTuple):
    S: torch.Tensor        # (B, D, D) covariance (PSD)
    m: torch.Tensor        # (B, D) expected returns
    gamma: torch.Tensor    # (B,) risk tolerance
    cap: torch.Tensor      # (B, D) per-asset weight cap


def sample_portfolio_arrays(seed: int, batch: int, nassets: int,
                            dtype=np.float32) -> dict:
    """Factor-model covariance F F'/D + 0.05 I (F with max(D // 4, 2)
    factors), returns 0.1 N(0, 1), gamma 0.5 + |N(0, 1)|, cap 4 / D."""
    rng = np.random.default_rng(seed)
    D = nassets
    F = rng.standard_normal((batch, D, max(D // 4, 2)))
    S = np.einsum("bik,bjk->bij", F, F) / D + 0.05 * np.eye(D)[None]
    m = 0.1 * rng.standard_normal((batch, D))
    gamma = 0.5 + np.abs(rng.standard_normal(batch))
    cap = np.full((batch, D), 4.0 / D)
    return _cast(dict(S=S, m=m, gamma=gamma, cap=cap), dtype)


def portfolio_data(arrays: dict, device=None, dtype=None) -> PortfolioData:
    return _tensors(PortfolioData, arrays, device, dtype)


def make_portfolio_problem(nassets: int) -> Problem:
    def f(x, p):
        return x @ (p.S @ x) - p.gamma * (p.m @ x)

    def ce(x, p):
        return torch.sum(x) - 1.0

    def ci(x, p):
        return torch.cat([x, p.cap - x])

    return Problem(f=f, nvar=nassets, neq=1, nineq=2 * nassets, ce=ce,
                   ci=ci)


def make_portfolio_batch_solver(config: IPMConfig,
                                nassets: int) -> BatchSolver:
    """``fn(x0 (B, D), data) -> SolverResult``."""
    return BatchSolver(make_portfolio_problem(nassets), config)


def portfolio_x0(batch: int, nassets: int, dtype=np.float32, device=None):
    """Strictly feasible uniform start."""
    return _full(batch, nassets, 1.0 / nassets, dtype, device)


# ----------------------------------------------------------------------
# SVM dual:  min 0.5 a'Qa - 1'a   s.t.  y'a = 0,  0 <= a <= C
class SVMData(NamedTuple):
    Q: torch.Tensor        # (B, n, n) = diag(y) K diag(y), PSD
    y: torch.Tensor        # (B, n) labels in {-1, +1}
    C: torch.Tensor        # (B,) box bound


def sample_svm_arrays(seed: int, batch: int, npoints: int, nfeat: int = 8,
                      dtype=np.float32) -> dict:
    """Points N(0, I) shifted by 0.5 y, linear kernel X X'/nfeat plus a
    1e-3 ridge (rank nfeat + ridge), labels +-1 with probability 1/2, C
    = 1."""
    rng = np.random.default_rng(seed)
    n = npoints
    X = rng.standard_normal((batch, n, nfeat))
    y = np.where(rng.random((batch, n)) < 0.5, 1.0, -1.0)
    X = X + 0.5 * y[..., None]
    Km = np.einsum("bif,bjf->bij", X, X) / nfeat + 1e-3 * np.eye(n)[None]
    Q = y[:, :, None] * Km * y[:, None, :]
    return _cast(dict(Q=Q, y=y, C=np.ones(batch)), dtype)


def svm_data(arrays: dict, device=None, dtype=None) -> SVMData:
    return _tensors(SVMData, arrays, device, dtype)


def make_svm_problem(npoints: int) -> Problem:
    def f(a, p):
        return 0.5 * a @ (p.Q @ a) - torch.sum(a)

    def ce(a, p):
        return p.y @ a

    def ci(a, p):
        return torch.cat([a, p.C - a])

    return Problem(f=f, nvar=npoints, neq=1, nineq=2 * npoints, ce=ce,
                   ci=ci)


def make_svm_batch_solver(config: IPMConfig, npoints: int) -> BatchSolver:
    return BatchSolver(make_svm_problem(npoints), config)


def svm_x0(data: SVMData):
    """Strictly feasible interior start: y'a = 0 with 0 < a < C, each class
    given equal total mass spread uniformly within it."""
    y = data.y
    npos = torch.clamp(torch.sum(y > 0, dim=-1, keepdim=True), min=1).to(
        y.dtype)
    nneg = torch.clamp(torch.sum(y < 0, dim=-1, keepdim=True), min=1).to(
        y.dtype)
    w = torch.where(y > 0, 1.0 / npos, 1.0 / nneg)
    return 0.1 * data.C[:, None] * w


# ----------------------------------------------------------------------
# Maximum entropy:  min sum(p log p)  s.t. 1'p = 1, Ap = b, p >= 0
class MaxEntData(NamedTuple):
    A: torch.Tensor        # (B, m, D) moment functions
    b: torch.Tensor        # (B, m) target moments


def sample_maxent_arrays(seed: int, batch: int, nstates: int,
                         nmoments: int = 2, dtype=np.float32) -> dict:
    """A ~ N(0, 1); targets b = A p of p = softmax(0.5 N(0, 1)), so every
    instance is feasible."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((batch, nmoments, nstates))
    logits = 0.5 * rng.standard_normal((batch, nstates))
    e = np.exp(logits - logits.max(-1, keepdims=True))
    p = e / e.sum(-1, keepdims=True)
    return _cast(dict(A=A, b=np.einsum("bmd,bd->bm", A, p)), dtype)


def maxent_data(arrays: dict, device=None, dtype=None) -> MaxEntData:
    return _tensors(MaxEntData, arrays, device, dtype)


def make_maxent_problem(nstates: int, nmoments: int = 2) -> Problem:
    def f(q, p):
        return torch.sum(q * torch.log(q + 1e-12))

    def ce(q, p):
        return torch.cat([torch.reshape(torch.sum(q) - 1.0, (1,)),
                          p.A @ q - p.b])

    def ci(q, p):
        return 1.0 * q

    return Problem(f=f, nvar=nstates, neq=1 + nmoments, nineq=nstates,
                   ce=ce, ci=ci)


def make_maxent_batch_solver(config: IPMConfig, nstates: int,
                             nmoments: int = 2) -> BatchSolver:
    return BatchSolver(make_maxent_problem(nstates, nmoments), config)


def maxent_x0(batch: int, nstates: int, dtype=np.float32, device=None):
    return _full(batch, nstates, 1.0 / nstates, dtype, device)


# ----------------------------------------------------------------------
# MPC: x_{t+1} = Ad x_t + Bd u_t over a horizon T, |u| <= umax, condensed
# to the stacked inputs u (nvar = T nu): the Hessian the solver sees is the
# dense (T nu)^2 control Hessian
class MPCData(NamedTuple):
    Ad: torch.Tensor       # (B, nx, nx)
    Bd: torch.Tensor       # (B, nx, nu)
    x_init: torch.Tensor   # (B, nx)
    x_ref: torch.Tensor    # (B, nx)
    umax: torch.Tensor     # (B,) input bound


def sample_mpc_arrays(seed: int, batch: int, nx: int = 4, nu: int = 2,
                      dtype=np.float32) -> dict:
    """Ad = I + 0.1 N(0, 1) divided by 1 + 0.1 (its largest absolute row
    sum), Bd = N(0, 1)/sqrt(nx), x_init ~ N(0, 1), x_ref ~ 0.5 N(0, 1),
    umax = 1."""
    rng = np.random.default_rng(seed)
    Ad = np.eye(nx)[None] + 0.1 * rng.standard_normal((batch, nx, nx))
    Ad = Ad / (1.0 + 0.1 * np.abs(Ad).sum(-1, keepdims=True).max(
        -2, keepdims=True))
    Bd = rng.standard_normal((batch, nx, nu)) / np.sqrt(nx)
    x_init = rng.standard_normal((batch, nx))
    x_ref = 0.5 * rng.standard_normal((batch, nx))
    return _cast(dict(Ad=Ad, Bd=Bd, x_init=x_init, x_ref=x_ref,
                      umax=np.ones(batch)), dtype)


def mpc_data(arrays: dict, device=None, dtype=None) -> MPCData:
    return _tensors(MPCData, arrays, device, dtype)


def make_mpc_problem(horizon: int, nu: int = 2) -> Problem:
    T = horizon
    D = T * nu

    def rollout_cost(u_flat, p):
        u = u_flat.reshape(T, nu)
        x = p.x_init
        cost = 0.0
        for t in range(T):
            x = p.Ad @ x + p.Bd @ u[t]
            cost = cost + (torch.sum((x - p.x_ref) ** 2)
                           + 0.1 * torch.sum(u[t] ** 2))
        return cost

    def ci(u_flat, p):
        return torch.cat([u_flat + p.umax, p.umax - u_flat])

    return Problem(f=rollout_cost, nvar=D, nineq=2 * D, ci=ci)


def make_mpc_batch_solver(config: IPMConfig, horizon: int,
                          nu: int = 2) -> BatchSolver:
    return BatchSolver(make_mpc_problem(horizon, nu), config)


def mpc_x0(batch: int, horizon: int, nu: int = 2, dtype=np.float32,
           device=None):
    return _full(batch, horizon * nu, 0.0, dtype, device)
