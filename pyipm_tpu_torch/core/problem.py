"""Problem specification and derivatives (counterpart of
``pyipm_tpu/core/problem.py``).

User callables are written for ONE instance and take ``(x, p)``: ``x`` is
the (D,) iterate and ``p`` a tuple (or NamedTuple) of that instance's data
tensors, ``()`` when the problem has none.  Every method here is batch
first: ``x`` is (B, D) and every tensor of ``p`` has a leading B axis; the
per-instance callables are mapped over the batch with ``torch.func.vmap``
and differentiated with ``torch.func.grad`` / ``jacfwd`` / ``hessian``.
Each batched derivative runs in a profiling scope: ``ipm-jacobian`` for
``grad_f``, ``jac_ce`` and ``jac_ci``, ``ipm-hessian`` for
``hess_lagrangian``.

Derivative overrides follow the reference's conventions (pyipm.py:223-225):

  - ``df(x, p) -> (D,)``           gradient of f
  - ``d2f(x, p) -> (D, D)``        Hessian of f
  - ``dce(x, p) -> (D, M)``        TRANSPOSED Jacobian of ce
  - ``d2ce(x, lda, p) -> (D, D)``  multiplier-contracted Hessian of ce
  - ``dci(x, p) -> (D, N)``        TRANSPOSED Jacobian of ci
  - ``d2ci(x, lda, p) -> (D, D)``  multiplier-contracted Hessian of ci
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.func import grad, hessian, jacfwd, vmap

from pyipm_tpu_torch import _sync
from pyipm_tpu_torch.utils import profiling


# ``vmap(hessian(f))`` (forward over ``jacrev``, the JAX package's
# ``jax.hessian``) moves B D^3 elements of x's dtype where per-instance
# data meets the D tangents, such as S in x'Sx or P in x'Px: at B > 1
# copies of the matrix, one for each tangent (477 GiB for 1,024 portfolios
# of 500 assets in float32); at B = 1 re-reads of the one matrix, a
# matrix-vector product for each tangent (512 GiB for one dense NLP of
# D = 4,096 in float64).  Forward over ``grad`` is the same derivative as
# matrix-matrix products; it is taken where that estimate passes this many
# bytes, so every smaller problem (each fleet of up to 2,048 instances of
# D <= 96, and one instance of D <= 1,024 in float64, among them) keeps
# ``hessian``'s bits.  ``_sync.COUNTS`` counts the calls of each route.
HESS_COPY_BYTES = 8 << 30


def _hess_map(fn, x, *rest):
    """The (B, D, D) Hessians of a per-instance scalar ``fn(x, *rest)``
    over a (B, D) batch."""
    B, D = x.shape
    if B * D ** 3 * x.element_size() > HESS_COPY_BYTES:
        _sync.COUNTS["hess_over_grad"] += 1
        return vmap(jacfwd(grad(fn)))(x, *rest)
    _sync.COUNTS["hess_hessian"] += 1
    return vmap(hessian(fn))(x, *rest)


def _map(fn, x, *rest):
    """Apply a per-instance ``fn(x, *rest)`` over a (B, D) batch, or over
    a (B, W, D) batch of W trial points per instance (``rest`` is then
    shared across the W axis)."""
    if x.dim() == 2:
        return vmap(fn)(x, *rest)
    if x.dim() == 3:
        inner = vmap(fn, in_dims=(0,) + (None,) * len(rest))
        return vmap(inner)(x, *rest)
    raise ValueError(f"x must be (B, D) or (B, W, D), got {tuple(x.shape)}")


@dataclasses.dataclass(frozen=True, eq=False)
class Problem:
    """Static problem description; composite layout as in the JAX package:
    z = [x (D); s (N); lda_e (M); lda_i (N)]."""

    f: Callable
    nvar: int
    neq: int = 0
    nineq: int = 0
    ce: Optional[Callable] = None
    ci: Optional[Callable] = None
    df: Optional[Callable] = None
    d2f: Optional[Callable] = None
    dce: Optional[Callable] = None
    d2ce: Optional[Callable] = None
    dci: Optional[Callable] = None
    d2ci: Optional[Callable] = None

    def __post_init__(self):
        if self.f is None:
            raise ValueError("f is required")
        if self.ce is None and (self.dce is not None or self.d2ce is not None):
            raise ValueError("dce/d2ce given without ce")
        if self.ci is None and (self.dci is not None or self.d2ci is not None):
            raise ValueError("dci/d2ci given without ci")
        if self.nvar <= 0:
            raise ValueError("nvar must be > 0")
        if (self.neq > 0) != (self.ce is not None):
            raise ValueError("neq > 0 exactly when ce is given")
        if (self.nineq > 0) != (self.ci is not None):
            raise ValueError("nineq > 0 exactly when ci is given")

    @property
    def ncon(self) -> int:
        return self.neq + self.nineq

    # ------------------------------------------------------------------
    # per-instance normalized evaluations
    def _f1(self, x, p):
        return torch.reshape(self.f(x, p), ())

    def _ce1(self, x, p):
        return torch.reshape(self.ce(x, p), (self.neq,))

    def _ci1(self, x, p):
        return torch.reshape(self.ci(x, p), (self.nineq,))

    # batched evaluations
    def f_val(self, x, p):
        return _map(self._f1, x, p)

    def ce_val(self, x, p):
        return _map(self._ce1, x, p)

    def ci_val(self, x, p):
        return _map(self._ci1, x, p)

    # ------------------------------------------------------------------
    # first derivatives (user override or autodiff, pyipm.py:473-509)
    def grad_f(self, x, p):
        with profiling.annotate("ipm-jacobian", x.device):
            if self.df is not None:
                return vmap(lambda x_, p_: torch.reshape(
                    self.df(x_, p_), (self.nvar,)))(x, p)
            return vmap(grad(self._f1))(x, p)

    def jac_ce(self, x, p):
        """TRANSPOSED equality Jacobian, (B, D, M), in x's dtype (forward
        mode of a 0-dim result minus a Python float comes out float64 for
        float32 x)."""
        with profiling.annotate("ipm-jacobian", x.device):
            if self.dce is not None:
                J = vmap(lambda x_, p_: torch.reshape(
                    self.dce(x_, p_), (self.nvar, self.neq)))(x, p)
            else:
                J = vmap(jacfwd(self._ce1))(x, p).transpose(1, 2)
            return J.to(x.dtype)

    def jac_ci(self, x, p):
        """TRANSPOSED inequality Jacobian, (B, D, N), in x's dtype."""
        with profiling.annotate("ipm-jacobian", x.device):
            if self.dci is not None:
                J = vmap(lambda x_, p_: torch.reshape(
                    self.dci(x_, p_), (self.nvar, self.nineq)))(x, p)
            else:
                J = vmap(jacfwd(self._ci1))(x, p).transpose(1, 2)
            return J.to(x.dtype)

    # ------------------------------------------------------------------
    # second derivatives
    def hess_f(self, x, p):
        if self.d2f is not None:
            return vmap(lambda x_, p_: torch.reshape(
                self.d2f(x_, p_), (self.nvar, self.nvar)))(x, p)
        return _hess_map(self._f1, x, p)

    def hess_ce(self, x, lda, p):
        """Hessian of sum(ce * lda[:M]); ``lda`` is the FULL multiplier."""
        D = self.nvar
        if self.d2ce is not None:
            return vmap(lambda x_, l_, p_: torch.reshape(
                self.d2ce(x_, l_, p_), (D, D)))(x, lda, p)
        lam = lda[:, :self.neq].detach()

        def contracted(x_, l_, p_):
            return torch.sum(self._ce1(x_, p_) * l_)

        return _hess_map(contracted, x, lam, p)

    def hess_ci(self, x, lda, p):
        D = self.nvar
        if self.d2ci is not None:
            return vmap(lambda x_, l_, p_: torch.reshape(
                self.d2ci(x_, l_, p_), (D, D)))(x, lda, p)
        lam = lda[:, self.neq:].detach()

        def contracted(x_, l_, p_):
            return torch.sum(self._ci1(x_, p_) * l_)

        return _hess_map(contracted, x, lam, p)

    def hess_lagrangian(self, x, lda, p):
        """d2L = d2f - d2ce - d2ci (reference pyipm.py:40, 816-821)."""
        with profiling.annotate("ipm-hessian", x.device):
            H = self.hess_f(x, p)
            if self.neq:
                H = H - self.hess_ce(x, lda, p)
            if self.nineq:
                H = H - self.hess_ci(x, lda, p)
            return H


def make_problem(f: Callable, nvar: int, ce: Optional[Callable] = None,
                 ci: Optional[Callable] = None, *, df=None, d2f=None,
                 dce=None, d2ce=None, dci=None, d2ci=None) -> Problem:
    """Build a :class:`Problem` whose callables read no per-instance data,
    inferring M and N by evaluating ce/ci on the meta device (shapes only).
    A family with data (``p``) names its counts in :class:`Problem`."""
    probe = torch.empty((nvar,), device="meta")

    def count(fn):
        if fn is None:
            return 0
        return int(torch.reshape(fn(probe, ()), (-1,)).shape[0])

    return Problem(f=f, nvar=int(nvar), neq=count(ce), nineq=count(ci),
                   ce=ce, ci=ci, df=df, d2f=d2f, dce=dce, d2ce=d2ce,
                   dci=dci, d2ci=d2ci)
