"""Solver configuration (counterpart of ``pyipm_tpu/config.py``).

The same fields, defaults and derived values as the JAX package's
``IPMConfig``, so a configuration can be carried across with
:meth:`IPMConfig.from_dict` on ``dataclasses.asdict`` of a JAX config.
Validation raises ``ValueError`` instead of asserting.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class IPMConfig:
    """All solver knobs (reference pyipm.py:311-376 defaults).

    ``matmul_precision="highest"`` means full float32 matrix products on
    the card: the solve turns TF32 off for its duration (see
    :func:`matmul_precision`).
    """

    mu: float = 0.2
    nu: float = 10.0
    rho: float = 0.1
    tau: float = 0.995
    eta: float = 1.0e-4
    beta: float = 0.4
    miter: int = 20
    niter: int = 10
    Xtol: Optional[float] = None   # accepted for parity, never read
    Ktol: float = 1.0e-4
    Ftol: Optional[float] = None
    lbfgs: int = 0
    lbfgs_zeta: Optional[float] = None
    float_dtype: str = "float64"
    verbosity: int = 1

    matmul_precision: str = "highest"
    mu_min: Optional[float] = None
    mu_strategy: str = "adaptive"
    linear_solver: str = "condensed"
    max_reg_retries: int = 40
    max_backtrack: int = 10_000
    backtrack_chunk: int = 32
    ldlt_block: int = 128
    schur_refine_steps: int = 2
    schur_refine_guard: bool = True
    trace_metrics: bool = False
    nan_guard: bool = True
    inject_solve_fault: float = 0.0

    def __post_init__(self):
        def check(ok, msg):
            if not ok:
                raise ValueError(msg)

        check(self.mu > 0.0, f"mu must be > 0, got {self.mu}")
        check(self.nu > 0.0, f"nu must be > 0, got {self.nu}")
        check(0.0 < self.eta < 1.0, f"eta must be in (0, 1), got {self.eta}")
        check(0.0 < self.rho < 1.0, f"rho must be in (0, 1), got {self.rho}")
        check(0.0 < self.tau < 1.0, f"tau must be in (0, 1), got {self.tau}")
        check(self.beta < 1.0, f"beta must be < 1, got {self.beta}")
        check(self.miter >= 0 and int(self.miter) == self.miter,
              f"miter must be a nonnegative integer, got {self.miter}")
        check(self.niter >= 0 and int(self.niter) == self.niter,
              f"niter must be a nonnegative integer, got {self.niter}")
        check(self.float_dtype in ("float32", "float64"),
              f"float_dtype must be float32 or float64, got "
              f"{self.float_dtype!r}")
        eps = self.eps
        check(self.Xtol is None or self.Xtol >= eps,
              f"Xtol must be >= machine eps ({eps}), got {self.Xtol}")
        check(self.Ktol >= eps,
              f"Ktol must be >= machine eps ({eps}), got {self.Ktol}")
        check(self.Ftol is None or self.Ftol >= 0.0,
              f"Ftol must be >= 0 or None, got {self.Ftol}")
        check(self.lbfgs >= 0, f"lbfgs memory must be >= 0, got {self.lbfgs}")
        check(self.lbfgs_zeta is None or self.lbfgs_zeta > 0.0,
              f"lbfgs_zeta must be > 0 or None, got {self.lbfgs_zeta}")
        check(self.linear_solver in ("condensed", "ldlt", "lu"),
              f"unknown linear_solver {self.linear_solver!r}")
        check(self.mu_strategy in ("adaptive", "mehrotra", "auto"),
              f"unknown mu_strategy {self.mu_strategy!r}")
        if self.mu_strategy == "mehrotra":
            check(self.linear_solver == "condensed",
                  "mehrotra requires linear_solver='condensed' (factor reuse)")
            check(not self.lbfgs, "mehrotra requires exact-Hessian mode")
        check(self.matmul_precision in ("default", "high", "highest"),
              f"unknown matmul_precision {self.matmul_precision!r}")

    @classmethod
    def from_dict(cls, d: dict) -> "IPMConfig":
        """Build from ``dataclasses.asdict`` of a JAX ``IPMConfig``."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"unknown IPMConfig fields {sorted(unknown)}")
        return cls(**d)

    # ------------------------------------------------------------------
    @property
    def np_dtype(self):
        return np.dtype(self.float_dtype)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.float_dtype)

    @property
    def eps(self) -> float:
        return float(np.finfo(self.np_dtype).eps)

    @property
    def xtol(self) -> float:
        return self.Xtol if self.Xtol is not None else self.eps

    @property
    def reg_coef(self) -> float:
        return float(np.sqrt(self.eps))

    @property
    def delta0(self) -> float:
        return self.reg_coef

    @property
    def mu_floor(self) -> float:
        """Barrier floor: eps in float64, eps**0.75 in float32 (see the
        JAX package's ``IPMConfig.mu_floor`` for the rationale)."""
        if self.mu_min is not None:
            return self.mu_min
        eps = self.eps
        return eps if eps < 1e-12 else float(eps ** 0.75)

    def replace(self, **kw) -> "IPMConfig":
        return dataclasses.replace(self, **kw)

    def resolve_mu_strategy(self, nineq: int) -> "IPMConfig":
        if self.mu_strategy != "auto":
            return self
        ok = (nineq > 0 and not self.lbfgs
              and self.linear_solver == "condensed")
        return self.replace(mu_strategy="mehrotra" if ok else "adaptive")


@contextlib.contextmanager
def matmul_precision(precision: str):
    """TF32 off for ``"highest"`` (full float32 products, as the JAX
    package's ``jax.default_matmul_precision("highest")``), on otherwise;
    both flags are restored on exit."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    allow = precision != "highest"
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
