"""Random NLP families (counterpart of ``pyipm_tpu/models/random_nlp.py``):
the QP fleet and the large dense nonconvex NLP.

Instance data is drawn with numpy from a seed, with the same distributions
as the JAX package's ``sample_qp_batch`` and ``sample_dense_nlp``
(random_nlp.py:45-58, 107-118).  The two packages' generators give
different numbers, so a parity test draws the data once with numpy and
hands the same arrays to both.

Data lands on the card unless the caller names another device: with
``device=None`` and no CUDA device the samplers raise rather than fall
back to the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pyipm_tpu_torch.core.problem import Problem


class QPData(NamedTuple):
    """Random inequality-constrained QP instances, leading axis = instance:

        min 0.5 x'Qx + c'x   s.t.   x - lb >= 0,  ub - x >= 0,  Ax - b >= 0

    Q is symmetric positive definite; x = 0 is strictly feasible."""
    Q: torch.Tensor       # (B, D, D)
    c: torch.Tensor       # (B, D)
    A: torch.Tensor       # (B, L, D)
    b: torch.Tensor       # (B, L)
    lb: torch.Tensor      # (B, D)
    ub: torch.Tensor      # (B, D)


def sample_qp_arrays(seed: int, B: int, D: int, nlin: int = 4,
                     dtype=np.float32) -> dict:
    """numpy arrays of a QP batch, keyed by QPData field."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, D, D))
    Q = np.einsum("bij,bkj->bik", G, G) / D + np.eye(D)[None]
    out = dict(
        Q=Q,
        c=rng.standard_normal((B, D)),
        A=rng.standard_normal((B, nlin, D)),
        b=-(np.abs(rng.standard_normal((B, nlin))) + 0.1),
        lb=-(np.abs(rng.standard_normal((B, D))) + 0.5),
        ub=np.abs(rng.standard_normal((B, D))) + 0.5,
    )
    return {k: v.astype(dtype) for k, v in out.items()}


def resolve_device(device=None) -> torch.device:
    """``device``, or the card when it is None; raises when the result is
    a CUDA device and none exists (the port never falls back quietly)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to place the "
                           "data on the CPU")
    return dev


def _tensors(cls, arrays: dict, device, dtype):
    dev = resolve_device(device)
    return cls(*(torch.tensor(np.asarray(arrays[k]), device=dev, dtype=dtype)
                 for k in cls._fields))


def qp_data(arrays: dict, device=None, dtype=None) -> QPData:
    """QPData from numpy arrays keyed by field name, on ``device`` (the
    card when None)."""
    return _tensors(QPData, arrays, device, dtype)


def sample_qp_batch(seed: int, B: int, D: int, nlin: int = 4, *,
                    dtype="float32", device=None) -> QPData:
    """A seeded batch of B random QPs with D variables and nlin linear
    inequalities (2D + nlin inequalities in all)."""
    return qp_data(sample_qp_arrays(seed, B, D, nlin, np.dtype(dtype)),
                   device=device)


def make_qp_problem(nvar: int, nlin: int) -> Problem:
    """The QP family as one Problem whose callables read their instance's
    data from ``p`` (a QPData row)."""

    def f(x, p):
        return 0.5 * x @ (p.Q @ x) + p.c @ x

    def ci(x, p):
        return torch.cat([x - p.lb, p.ub - x, p.A @ x - p.b])

    return Problem(f=f, nvar=nvar, nineq=2 * nvar + nlin, ci=ci)


# ----------------------------------------------------------------------
# large dense nonconvex NLP (the blocked-LDL^T configuration)
class DenseNLPData(NamedTuple):
    """min 0.5 x'Px + c'x + alpha * sum(tanh(Wx/sqrt(D)))  s.t.  Aeq x = beq

    Nonconvex (tanh features), D variables, M equality constraints.  As
    the solver's ``params`` every field has a leading instance axis."""
    P: torch.Tensor       # (D, D) positive definite quadratic part
    c: torch.Tensor       # (D,)
    W: torch.Tensor       # (H, D) feature weights
    Aeq: torch.Tensor     # (M, D)
    beq: torch.Tensor     # (M,)
    alpha: torch.Tensor   # ()


def sample_dense_arrays(seed: int, D: int, M: int, hidden: int = 256,
                        dtype=np.float32) -> dict:
    """numpy arrays of one dense NLP, keyed by DenseNLPData field; drawn
    in float64, then cast.  beq = Aeq xfeas keeps the constraints
    feasible."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((D, D)) / np.sqrt(D)
    out = dict(P=G @ G.T + 0.5 * np.eye(D),
               c=rng.standard_normal(D),
               W=rng.standard_normal((hidden, D)),
               Aeq=rng.standard_normal((M, D)) / np.sqrt(D),
               alpha=np.asarray(0.5))
    out["beq"] = out["Aeq"] @ (0.1 * rng.standard_normal(D))
    return {k: np.asarray(v, dtype=dtype) for k, v in out.items()}


def dense_nlp_data(arrays: dict, device=None, dtype=None) -> DenseNLPData:
    """DenseNLPData from numpy arrays keyed by field name, on ``device``
    (the card when None)."""
    return _tensors(DenseNLPData, arrays, device, dtype)


def sample_dense_nlp(seed: int, D: int, M: int, hidden: int = 256, *,
                     dtype="float32", device=None) -> DenseNLPData:
    """A seeded dense NLP with D variables, M equalities and ``hidden``
    tanh features (one instance, no batch axis)."""
    return dense_nlp_data(
        sample_dense_arrays(seed, D, M, hidden, np.dtype(dtype)),
        device=device)


def make_dense_nlp_problem(nvar: int, neq: int) -> Problem:
    """The dense NLP family as one Problem whose callables read their
    instance's data from ``p`` (a DenseNLPData row)."""
    sqrtD = float(np.sqrt(nvar))

    def f(x, p):
        feat = torch.tanh(p.W @ x / sqrtD)
        return 0.5 * x @ (p.P @ x) + p.c @ x + p.alpha * torch.sum(feat)

    def ce(x, p):
        return p.Aeq @ x - p.beq

    return Problem(f=f, nvar=nvar, neq=neq, ce=ce)
