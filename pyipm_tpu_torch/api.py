"""Class facade of the reference ``IPM`` contract (counterpart of
``pyipm_tpu/api.py``).

The reference constructor, solve and KKT surface (reference pyipm.py:23,
311-376, 1567, 958): the same keyword names and defaults, the same 5-tuple
``(x, s, lda, fval, kkt)`` of numpy arrays, the same final report.

As everywhere in the port, ``f``/``ce``/``ci`` and the derivative
overrides are torch callables ``(x, p)`` (``p`` is ``()`` here: the facade
solves one instance with no data), and the solve runs on ``device``: the
card unless ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pyipm_tpu_torch.config import IPMConfig
from pyipm_tpu_torch.core import kkt as kkt_mod
from pyipm_tpu_torch.core.problem import Problem
from pyipm_tpu_torch.core.solver import solve
from pyipm_tpu_torch.models.random_nlp import resolve_device


class IPM:
    """Solve ``min f(x) s.t. ce(x) = 0, ci(x) >= 0`` by the line-search
    primal-dual interior-point method of Nocedal & Wright ch. 19, as the
    reference does (pyipm.py:23-1863): slacks ``s`` with a log barrier of
    weight ``mu``, Newton steps on the primal-dual KKT system with inertia
    correction, an l1 merit function with Armijo backtracking and a
    second-order correction, fraction-to-the-boundary steps, and an
    adaptive barrier update.

    Problem: ``x0`` (D,) initial guess (fixes D); ``f(x, p) -> scalar``;
    ``ce(x, p) -> (M,)`` and ``ci(x, p) -> (N,)`` or None.  ``x_dev`` and
    ``lambda_dev`` (the reference's symbolic placeholders) are accepted and
    ignored.

    Optional derivatives (autodiff when omitted; the Jacobians TRANSPOSED
    as in the reference, pyipm.py:223-225): ``df(x, p) -> (D,)``,
    ``d2f(x, p) -> (D, D)``, ``dce(x, p) -> (D, M)``,
    ``d2ce(x, lda, p) -> (D, D)`` (the Hessian of ce . lda[:M], ``lda`` the
    full (M+N,) multiplier), ``dci(x, p) -> (D, N)``,
    ``d2ci(x, lda, p) -> (D, D)`` (against lda[M:]).

    Warm starts: ``s0`` (N,), ``lda0`` (M+N,); by default max(ci(x0),
    Ktol) and the least-squares multiplier estimate.

    Hyperparameters, with the reference's defaults (pyipm.py:311-314):
    ``mu`` 0.2, ``nu`` 10.0, ``rho`` 0.1, ``tau`` 0.995, ``eta`` 1e-4,
    ``beta`` 0.4, ``miter`` 20, ``niter`` 10, ``Ktol`` 1e-4, ``Xtol``
    (validated, never read: the fraction-to-the-boundary step is closed
    form), ``Ftol`` None, ``lbfgs`` False (an integer m uses L-BFGS memory
    m in place of the exact Hessian), ``lbfgs_zeta`` None (1.0),
    ``float_dtype`` np.float64, ``verbosity`` 1 (-1 silent, 0 the final
    report, 1 also the mode banner and iteration counters, 2 also f(x), 3
    also the KKT norms), ``linear_solver`` None (the IPMConfig default,
    'condensed'; 'ldlt' factors the full KKT matrix, 'lu' reproduces the
    reference's eigenvalue-inertia flow).  ``device``: where the solve
    runs, the card when None (which raises without one).

    ``solve(x0=None, s0=None, lda0=None, force_recompile=False, mu0=None,
    nu0=None)`` returns ``(x, s, lda, fval, kkt)`` and stores them, with
    ``signal``, ``mu`` and ``nu``, on the instance.  mu and nu start from
    the constructor's values on every solve; ``mu0``/``nu0`` override them
    for one solve (feed ``self.mu``/``self.nu`` back in for the
    reference's stateful warm start, pyipm.py:273-275).

    ``KKT(x, s, lda, mu=None)`` returns the four KKT blocks: the Lagrangian
    gradient (D,), s*(lda_i - mu/s) (N,), ce (M,) and ci - s (N,), an
    absent block as scalar 0 (pyipm.py:958-991).
    """

    def __init__(self, x0=None, x_dev=None, f=None, df=None, d2f=None,
                 ce=None, dce=None, d2ce=None, ci=None, dci=None, d2ci=None,
                 lda0=None, lambda_dev=None, s0=None, mu=0.2, nu=10.0,
                 rho=0.1, tau=0.995, eta=1.0E-4, beta=0.4, miter=20,
                 niter=10, Xtol=None, Ktol=1.0E-4, Ftol=None, lbfgs=False,
                 lbfgs_zeta=None, float_dtype=np.float64, verbosity=1,
                 linear_solver=None, device=None):
        del x_dev, lambda_dev
        self.x0 = None if x0 is None else np.asarray(x0)
        self.lda0 = None if lda0 is None else np.asarray(lda0)
        self.s0 = None if s0 is None else np.asarray(s0)
        self.f, self.df, self.d2f = f, df, d2f
        self.ce, self.dce, self.d2ce = ce, dce, d2ce
        self.ci, self.dci, self.d2ci = ci, dci, d2ci
        solver_kw = ({} if linear_solver is None
                     else {"linear_solver": linear_solver})
        self.config = IPMConfig(
            mu=mu, nu=nu, rho=rho, tau=tau, eta=eta, beta=beta,
            miter=int(miter), niter=int(niter), Xtol=Xtol, Ktol=Ktol,
            Ftol=Ftol, lbfgs=int(lbfgs) if lbfgs else 0,
            lbfgs_zeta=lbfgs_zeta,
            float_dtype=np.dtype(float_dtype).name, verbosity=verbosity,
            **solver_kw)
        self.float_dtype = np.dtype(float_dtype).type
        self.verbosity = verbosity
        self.device = resolve_device(device)

        self.nvar = self.neq = self.nineq = None
        self.problem: Optional[Problem] = None
        self.compiled = False

        # populated by solve() (reference pyipm.py:1816-1821)
        self.x = self.s = self.lda = self.kkt = self.fval = None
        self.signal = None
        self.mu = None           # final barrier value of the last solve
        self.nu = None           # final merit penalty of the last solve

    # ------------------------------------------------------------------
    def validate(self):
        """Input validation (reference pyipm.py:385-408); the
        hyperparameter ranges are checked by IPMConfig."""
        if self.f is None:
            raise ValueError("an objective f must be supplied")
        if self.ce is None and (self.dce is not None
                                or self.d2ce is not None):
            raise ValueError("dce/d2ce supplied without ce")
        if self.ci is None and (self.dci is not None
                                or self.d2ci is not None):
            raise ValueError("dci/d2ci supplied without ci")

    def compile(self, nvar=None, neq=None, nineq=None):
        """Build the Problem, counting the constraints (reference
        compile(), pyipm.py:410-956).  Nothing is compiled: the port runs
        eagerly."""
        if nvar is not None:
            self.nvar = int(nvar)
        elif self.x0 is not None:
            self.nvar = int(self.x0.size)
        if self.nvar is None:
            raise ValueError("nvar unknown: supply x0 or nvar")
        self.validate()
        self.problem = Problem(
            f=self.f, nvar=self.nvar,
            neq=self._count(self.ce, neq), nineq=self._count(self.ci, nineq),
            ce=self.ce, ci=self.ci, df=self.df, d2f=self.d2f,
            dce=self.dce, d2ce=self.d2ce, dci=self.dci, d2ci=self.d2ci)
        self.neq = self.problem.neq
        self.nineq = self.problem.nineq
        self.compiled = True

    def _count(self, fn, override):
        """Outputs of ``fn``, from one call on a zero x."""
        if fn is None:
            return 0
        if override is not None:
            return int(override)
        x = torch.zeros((self.nvar,), dtype=self.config.torch_dtype,
                        device=self.device)
        return int(torch.as_tensor(fn(x, ())).numel())

    def _tensor(self, a):
        return torch.as_tensor(np.array(a, dtype=self.config.np_dtype),
                               device=self.device)

    # ------------------------------------------------------------------
    def solve(self, x0=None, s0=None, lda0=None, force_recompile=False,
              mu0=None, nu0=None):
        """Run the solver (reference IPM.solve, pyipm.py:1567-1863);
        returns (x, s, lda, fval, kkt)."""
        if x0 is not None:
            self.x0 = np.asarray(x0)
        if s0 is not None:
            self.s0 = np.asarray(s0)
        if lda0 is not None:
            self.lda0 = np.asarray(lda0)
        if self.x0 is None or self.x0.size == 0 or self.x0.ndim != 1:
            raise ValueError("x0 must be a non-empty 1-D array")
        if (not self.compiled or force_recompile
                or self.nvar != self.x0.size):
            self.nvar = int(self.x0.size)
            self.compile()

        use_s0 = self.s0 is not None and self.problem.nineq > 0
        use_lda0 = self.lda0 is not None and self.problem.ncon > 0
        res = solve(self.problem, self._tensor(self.x0), self.config,
                    s0=self._tensor(self.s0) if use_s0 else None,
                    lda0=self._tensor(self.lda0) if use_lda0 else None,
                    mu0=mu0, nu0=nu0)

        self.x = res.x.cpu().numpy()
        self.s = res.s.cpu().numpy()
        self.lda = res.lda.cpu().numpy()
        self.fval = float(res.fval)
        self.signal = int(res.signal)
        self.mu = float(res.mu)
        self.nu = float(res.nu)
        self.kkt = self.KKT(self.x, self.s, self.lda)
        self._report(res)
        return self.x, self.s, self.lda, self.fval, self.kkt

    # ------------------------------------------------------------------
    def KKT(self, x, s, lda, mu=None):
        """First-order KKT blocks at (x, s, lda) (reference IPM.KKT,
        pyipm.py:958-991).  ``mu`` defaults to the current barrier value:
        the final mu of the last solve, else the configured initial one
        (pyipm.py:968)."""
        if self.problem is None:
            self.nvar = int(np.asarray(x).size)
            self.compile()
        if mu is None:
            if self.mu is not None:
                mu = self.mu
            else:
                mu = (self.config.mu if self.problem.nineq
                      else self.config.Ktol)
        blocks = kkt_mod.kkt_blocks(
            self.problem, self._tensor(x)[None], self._tensor(s)[None],
            self._tensor(lda)[None], self._tensor(mu).reshape(1), ())
        return [b[0].cpu().numpy() for b in blocks]

    # ------------------------------------------------------------------
    def _report(self, res):
        """Final convergence report (reference pyipm.py:1823-1860)."""
        if self.verbosity < 0:
            return
        kktn = res.kkt.cpu().numpy()
        msg = []
        if self.signal == -2:
            msg.append('Terminated due to bad direction in backtracking '
                       'line search')
        elif self.signal == -3:
            msg.append('Terminated on non-finite iterate')
        elif np.all(kktn <= self.config.Ktol):
            msg.append('Converged to Ktol tolerance')
        elif self.signal == 2:
            msg.append('Converged to Ftol tolerance')
        else:
            msg.append('Maximum iterations reached')
        outer = int(res.outer)
        inner = int(res.inner)
        total = int(res.iter_count)
        if self.problem.nineq:
            if outer > 1:
                msg.append('after {} outer'.format(outer - 1))
                msg.append('iterations' if outer > 2 else 'iteration')
                msg.append('and')
            else:
                msg.append('after')
            msg.append('{} inner'.format(inner))
            msg.append('iterations' if inner > 1 else 'iteration')
            msg.append('({} total).'.format(total))
        else:
            msg.append('after {}'.format(total))
            msg.append('iterations.' if total > 1 else 'iteration.')
        print(' '.join(msg))
        if self.verbosity > 1:
            line = ['FINAL: f(x) = {}'.format(self.fval)]
            if self.verbosity > 2:
                line.append('|dL/dx| = {}'.format(kktn[0]))
                line.append('|dL/ds| = {}'.format(kktn[1]))
                line.append('|ce| = {}'.format(kktn[2]))
                line.append('|ci-s| = {}'.format(kktn[3]))
            print(', '.join(line))
