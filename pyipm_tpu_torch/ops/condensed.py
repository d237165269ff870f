"""Condensed KKT direction, batch first (counterpart of
``pyipm_tpu/ops/condensed.py``).

With Sigma = diag(lda_i/(s+guard)) the Newton system of the full
(D+2N+M)^2 KKT matrix reduces exactly to the (D+M)^2 system

    [ W + Ji Sig Ji' + delta*I   Je ] [dx]   [g1 + Ji (Sig g4 + g2)]
    [ Je'                         0 ] [da] = [g3]

with ds = Ji' dx - g4 and db = Sig ds - g2 recovered elementwise, then two
guarded refinement steps against the full regularized system.
"""

from __future__ import annotations

import torch

from pyipm_tpu_torch.core import kkt as K
from pyipm_tpu_torch.core.problem import Problem
from pyipm_tpu_torch.ops.linalg import matvec as _mv, reg_solve_kkt


def _sumsq(v):
    return torch.sum(v ** 2, dim=-1)


def condensed_direction(problem: Problem, cfg, x, s, lda, mu, delta, p):
    """Newton step of the full KKT system via condensation.

    x (B, D), s (B, N), lda (B, M+N), mu and delta (B,).  Returns
    (dz (B, D+2N+M) in the full layout [dx; ds; da; db], delta_new,
    retries)."""
    D, M, N = problem.nvar, problem.neq, problem.nineq
    B = x.shape[0]
    guard = K._eps_of(x)

    g = -K.grad(problem, x, s, lda, mu, p)
    g1 = g[:, :D]
    g2 = g[:, D:D + N]
    g3 = g[:, D + N:D + N + M]
    g4 = g[:, D + N + M:]

    d2L = problem.hess_lagrangian(x, lda, p)
    W = torch.triu(d2L) + torch.triu(d2L, 1).transpose(1, 2)

    if N:
        Ji = problem.jac_ci(x, p)                            # (B, D, N)
        sig = lda[:, M:] / (s + guard)
        A = W + torch.matmul(Ji * sig[:, None, :], Ji.transpose(1, 2))
        rhs1 = g1 + _mv(Ji, sig * g4 + g2)
    else:
        Ji = x.new_zeros((B, D, 0))
        sig = x.new_zeros((B, 0))
        A = W
        rhs1 = g1

    if M:
        Je = problem.jac_ce(x, p)                            # (B, D, M)
        Kc = x.new_zeros((B, D + M, D + M))
        Kc[:, :D, :D] = A
        Kc[:, :D, D:] = Je
        Kc[:, D:, :D] = Je.transpose(1, 2)
        rhs = torch.cat([rhs1, g3], dim=-1)
    else:
        Je = x.new_zeros((B, D, 0))
        Kc = A
        rhs = rhs1

    Kc = (Kc + Kc.transpose(1, 2)) * 0.5

    dxa, delta_new, retries, apply_factors, applied = reg_solve_kkt(
        Kc, rhs, delta, mu, nvar=D, neq=M, nineq=0, eps=cfg.eps,
        reg_coef=cfg.reg_coef, eta=cfg.eta, beta=cfg.beta,
        delta0=cfg.delta0, max_retries=cfg.max_reg_retries,
        want_solver=True, block=cfg.ldlt_block)
    delta_applied, eq_applied = applied
    JiT = Ji.transpose(1, 2)
    JeT = Je.transpose(1, 2)

    def recover(dxa_):
        dx = dxa_[:, :D]
        da = dxa_[:, D:]
        ds = _mv(JiT, dx) - g4
        db = sig * ds - g2
        return dx, ds, da, db

    def full_residual(dx, ds, da, db):
        """Residual of the REGULARIZED full Newton system by block
        matvecs, applied shifts included (condensed.py:104-118)."""
        r1 = g1 - (_mv(W, dx) + delta_applied[:, None] * dx + _mv(Je, da)
                   + _mv(Ji, db))
        r2 = g2 - (sig * ds - db) if N else g2
        r3 = g3 - (_mv(JeT, dx) - eq_applied[:, None] * da) if M else g3
        r4 = g4 - (_mv(JiT, dx) - ds) if N else g4
        return r1, r2, r3, r4

    def condensed_apply(r1, r2, r3, r4):
        rr1 = r1 + _mv(Ji, sig * r4 + r2) if N else r1
        rr = torch.cat([rr1, r3], dim=-1) if M else rr1
        sol = apply_factors(rr)
        ex = sol[:, :D]
        ea = sol[:, D:]
        es = _mv(JiT, ex) - r4
        eb = sig * es - r2
        return ex, es, ea, eb

    dx, ds, da, db = recover(dxa)
    for _ in range(2):
        r = full_residual(dx, ds, da, db)
        rn0 = sum(_sumsq(ri) for ri in r)
        ex, es, ea, eb = condensed_apply(*r)
        dx2, ds2, da2, db2 = dx + ex, ds + es, da + ea, db + eb
        rn1 = sum(_sumsq(ri) for ri in full_residual(dx2, ds2, da2, db2))
        better = (rn1 < rn0)[:, None]
        dx = torch.where(better, dx2, dx)
        ds = torch.where(better, ds2, ds)
        da = torch.where(better, da2, da)
        db = torch.where(better, db2, db)

    dz = torch.cat([dx, ds, da, db], dim=-1)
    return dz, delta_new, retries
