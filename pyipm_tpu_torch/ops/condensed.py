"""Condensed KKT direction, batch first (counterpart of
``pyipm_tpu/ops/condensed.py``).

With Sigma = diag(lda_i/(s+guard)) the Newton system of the full
(D+2N+M)^2 KKT matrix reduces exactly to the (D+M)^2 system

    [ W + Ji Sig Ji' + delta*I   Je ] [dx]   [g1 + Ji (Sig g4 + g2)]
    [ Je'                         0 ] [da] = [g3]

with ds = Ji' dx - g4 and db = Sig ds - g2 recovered elementwise, then two
guarded refinement steps against the full regularized system.  The
condensed matrix does not depend on mu, so the Mehrotra predictor-corrector
factors it once and solves its predictor, corrector and refinement
right-hand sides against the same factors.
"""

from __future__ import annotations

import torch

from pyipm_tpu_torch.core import kkt as K
from pyipm_tpu_torch.core.linesearch import max_step_ftb
from pyipm_tpu_torch.core.problem import Problem
from pyipm_tpu_torch.ops.linalg import matvec as _mv, reg_solve_kkt


def _sumsq(v):
    return torch.sum(v ** 2, dim=-1)


class _Condensed:
    """The condensed system of one iterate: its blocks, its right-hand
    side for any residual, its factorization, and the refined recovery of
    the full step from a condensed solution."""

    def __init__(self, problem: Problem, x, s, lda, p):
        D, M, N = problem.nvar, problem.neq, problem.nineq
        B = x.shape[0]
        self.D, self.M, self.N = D, M, N
        d2L = problem.hess_lagrangian(x, lda, p)
        W = torch.triu(d2L) + torch.triu(d2L, 1).transpose(1, 2)
        if N:
            Ji = problem.jac_ci(x, p)                        # (B, D, N)
            sig = lda[:, M:] / (s + K._eps_of(x))
            A = W + torch.matmul(Ji * sig[:, None, :], Ji.transpose(1, 2))
        else:
            Ji = x.new_zeros((B, D, 0))
            sig = x.new_zeros((B, 0))
            A = W
        if M:
            Je = problem.jac_ce(x, p)                        # (B, D, M)
            Kc = x.new_zeros((B, D + M, D + M))
            Kc[:, :D, :D] = A
            Kc[:, :D, D:] = Je
            Kc[:, D:, :D] = Je.transpose(1, 2)
        else:
            Je = x.new_zeros((B, D, 0))
            Kc = A
        self.W, self.Ji, self.Je, self.sig = W, Ji, Je, sig
        self.JiT, self.JeT = Ji.transpose(1, 2), Je.transpose(1, 2)
        self.Kc = (Kc + Kc.transpose(1, 2)) * 0.5

    def rhs(self, r1, r2, r3, r4):
        """Condensed right-hand side of the full residual (r1..r4)."""
        rr1 = r1 + _mv(self.Ji, self.sig * r4 + r2) if self.N else r1
        return torch.cat([rr1, r3], dim=-1) if self.M else rr1

    def factor(self, cfg, rhs, delta, mu):
        """Inertia-corrected factorization with the first solve of
        ``rhs``: returns (solution, delta_new, retries) and keeps the
        factors and the applied shifts for :meth:`refined`."""
        sol, delta_new, retries, self.apply, applied = reg_solve_kkt(
            self.Kc, rhs, delta, mu, nvar=self.D, neq=self.M, nineq=0,
            eps=cfg.eps, reg_coef=cfg.reg_coef, eta=cfg.eta, beta=cfg.beta,
            delta0=cfg.delta0, max_retries=cfg.max_reg_retries,
            want_solver=True, block=cfg.ldlt_block)
        self.delta_applied, self.eq_applied = applied
        return sol, delta_new, retries

    def _recover(self, sol, r2, r4):
        dx = sol[:, :self.D]
        da = sol[:, self.D:]
        ds = _mv(self.JiT, dx) - r4
        db = self.sig * ds - r2
        return dx, ds, da, db

    def _residual(self, g, dx, ds, da, db):
        """Residual of the REGULARIZED full Newton system by block
        matvecs, applied shifts included (JAX condensed.py:104-118)."""
        g1, g2, g3, g4 = g
        r1 = g1 - (_mv(self.W, dx) + self.delta_applied[:, None] * dx
                   + _mv(self.Je, da) + _mv(self.Ji, db))
        r2 = g2 - (self.sig * ds - db) if self.N else g2
        r3 = (g3 - (_mv(self.JeT, dx) - self.eq_applied[:, None] * da)
              if self.M else g3)
        r4 = g4 - (_mv(self.JiT, dx) - ds) if self.N else g4
        return r1, r2, r3, r4

    def refined(self, sol, g):
        """The full step (dx, ds, da, db) of the condensed solution ``sol``
        of residual ``g`` = (g1, g2, g3, g4), after two refinement steps
        against the cached factors, each kept only where it reduces the
        full residual."""
        dx, ds, da, db = self._recover(sol, g[1], g[3])
        for _ in range(2):
            r = self._residual(g, dx, ds, da, db)
            rn0 = sum(_sumsq(ri) for ri in r)
            ex, es, ea, eb = self._recover(self.apply(self.rhs(*r)), r[1],
                                           r[3])
            dx2, ds2, da2, db2 = dx + ex, ds + es, da + ea, db + eb
            rn1 = sum(_sumsq(ri)
                      for ri in self._residual(g, dx2, ds2, da2, db2))
            better = (rn1 < rn0)[:, None]
            dx = torch.where(better, dx2, dx)
            ds = torch.where(better, ds2, ds)
            da = torch.where(better, da2, da)
            db = torch.where(better, db2, db)
        return dx, ds, da, db


def _split(problem: Problem, g):
    D, M, N = problem.nvar, problem.neq, problem.nineq
    return (g[:, :D], g[:, D:D + N], g[:, D + N:D + N + M],
            g[:, D + N + M:])


def condensed_direction(problem: Problem, cfg, x, s, lda, mu, delta, p):
    """Newton step of the full KKT system via condensation.

    x (B, D), s (B, N), lda (B, M+N), mu and delta (B,).  Returns
    (dz (B, D+2N+M) in the full layout [dx; ds; da; db], delta_new,
    retries)."""
    g = _split(problem, -K.grad(problem, x, s, lda, mu, p))
    sysm = _Condensed(problem, x, s, lda, p)
    sol, delta_new, retries = sysm.factor(cfg, sysm.rhs(*g), delta, mu)
    dz = torch.cat(sysm.refined(sol, g), dim=-1)
    return dz, delta_new, retries


def condensed_direction_mehrotra(problem: Problem, cfg, x, s, lda, mu,
                                 delta, mu_floor, p):
    """Mehrotra predictor-corrector direction (JAX condensed.py:152-277).

    One factorization (the condensed matrix is mu-independent), then:

      1. predictor: the affine-scaling step (mu = 0 complementarity);
      2. sigma = (mu_aff / mu_mean)^3 from the affine step's progress to
         the boundary (tau = 1), mu_new = max(sigma * mu_mean, mu_floor);
      3. corrector: the centered right-hand side at mu_new plus the
         second-order term ds_aff o dli_aff, solved on the same factors.

    Returns (dz, mu_new, delta_new, retries), dz in the pre-flip layout of
    :func:`condensed_direction`; each instance adopts its ``mu_new``, and
    the merit line search uses it.  Requires N > 0."""
    M, N = problem.neq, problem.nineq
    if not N:
        raise ValueError("the Mehrotra predictor-corrector needs inequality "
                         "slacks")
    guard = K._eps_of(x)
    li = lda[:, M:]
    g1, g2_aff, g3, g4 = _split(
        problem, -K.grad(problem, x, s, lda, torch.zeros_like(mu), p))
    sysm = _Condensed(problem, x, s, lda, p)
    sol, delta_new, retries = sysm.factor(cfg, sysm.rhs(g1, g2_aff, g3, g4),
                                          delta, mu)

    # predictor
    _, ds_a, _, db_a = sysm.refined(sol, (g1, g2_aff, g3, g4))
    dli_a = -db_a                       # post-flip multiplier step
    a_s = max_step_ftb(s, ds_a, 1.0)
    a_l = max_step_ftb(li, dli_a, 1.0)
    mu_mean = torch.sum(s * li, dim=-1) / N
    mu_aff = torch.sum((s + a_s[:, None] * ds_a) * (li + a_l[:, None] * dli_a),
                       dim=-1) / N
    sigma = torch.clamp((mu_aff / (mu_mean + guard)) ** 3, 0.0, 1.0)
    mu_new = torch.clamp(sigma * mu_mean, min=mu_floor)

    # corrector: g2 = mu_new/s - li - (ds_aff o dli_aff)/s
    g2_c = g2_aff + (mu_new[:, None] - ds_a * dli_a) / (s + guard)
    g_c = (g1, g2_c, g3, g4)
    dz = torch.cat(sysm.refined(sysm.apply(sysm.rhs(*g_c)), g_c), dim=-1)
    return dz, mu_new, delta_new, retries
