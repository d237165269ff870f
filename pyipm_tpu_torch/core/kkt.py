"""KKT residuals, merit function and initializers, batch first
(counterpart of ``pyipm_tpu/core/kkt.py``).

Every function takes (B, ...) tensors and the per-instance data ``p``
(leading B axis).  Layout of the composite residual (pyipm.py:654-668):

    r = [ df - dce.lda_e - dci.lda_i   (D)
          lda_i - mu/(s+guard)         (N)
          ce(x)                        (M)
          ci(x) - s                    (N) ]
"""

from __future__ import annotations

import torch

from pyipm_tpu_torch.core.problem import Problem
from pyipm_tpu_torch.ops.linalg import lstsq_minnorm, matvec as _mv


def _eps_of(x):
    """Slack-denominator guard sqrt(tiny), not machine eps: in float32 an
    eps guard dominates active slacks near convergence and stalls the
    stationarity residual (see the JAX package's ``kkt._eps_of``)."""
    return float(torch.finfo(x.dtype).tiny) ** 0.5


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def con(problem: Problem, x, s, p):
    """Composite constraints [ce(x); ci(x) - s], (B, M+N)."""
    parts = []
    if problem.neq:
        parts.append(problem.ce_val(x, p))
    if problem.nineq:
        parts.append(problem.ci_val(x, p) - s)
    if not parts:
        return x.new_zeros(x.shape[:-1] + (0,))
    return torch.cat(parts, dim=-1)


def jaco(problem: Problem, x, p):
    """Composite constraint Jacobian (B, D+N, M+N):
    [[dce, dci], [0, -I]]."""
    D, M, N = problem.nvar, problem.neq, problem.nineq
    J = x.new_zeros((x.shape[0], D + N, M + N))
    if M:
        J[:, :D, :M] = problem.jac_ce(x, p)
    if N:
        J[:, :D, M:] = problem.jac_ci(x, p)
        J[:, D:, M:] = -torch.eye(N, dtype=x.dtype, device=x.device)
    return J


def grad(problem: Problem, x, s, lda, mu, p):
    """Length D+2N+M residual (B, K) (reference pyipm.py:609-668)."""
    M, N = problem.neq, problem.nineq
    eps = _eps_of(x)
    gx = problem.grad_f(x, p)
    if M:
        gx = gx - _mv(problem.jac_ce(x, p), lda[:, :M])
    if N:
        gx = gx - _mv(problem.jac_ci(x, p), lda[:, M:])
    parts = [gx]
    if N:
        parts.append(lda[:, M:] - mu[:, None] / (s + eps))
    if M:
        parts.append(problem.ce_val(x, p))
    if N:
        parts.append(problem.ci_val(x, p) - s)
    return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]


def kkt_norms(problem: Problem, x, s, lda, mu, p):
    """The four KKT condition norms, (B, 4); absent blocks are 0."""
    D, M, N = problem.nvar, problem.neq, problem.nineq
    r = grad(problem, x, s, lda, mu, p)
    zero = x.new_zeros((x.shape[0],))
    k1 = torch.linalg.vector_norm(r[:, :D], dim=-1)
    k2 = (torch.linalg.vector_norm(r[:, D:D + N] * s, dim=-1)
          if N else zero)
    k3 = (torch.linalg.vector_norm(r[:, D + N:D + N + M], dim=-1)
          if M else zero)
    k4 = torch.linalg.vector_norm(r[:, D + N + M:], dim=-1) if N else zero
    return torch.stack([k1, k2, k3, k4], dim=-1)


def kkt_blocks(problem: Problem, x, s, lda, mu, p):
    """The four KKT condition blocks (reference IPM.KKT, pyipm.py:958-991):
    (B, D), (B, N), (B, M), (B, N); an absent block is (B,) zeros."""
    D, M, N = problem.nvar, problem.neq, problem.nineq
    r = grad(problem, x, s, lda, mu, p)
    zero = x.new_zeros((x.shape[0],))
    return (r[:, :D],
            r[:, D:D + N] * s if N else zero,
            r[:, D + N:D + N + M] if M else zero,
            r[:, D + N + M:] if N else zero)


def kkt_matrix(problem: Problem, x, s, lda, mu, p):
    """Symmetric (B, K, K) primal-dual matrix, K = D+2N+M (reference
    pyipm.py:816-844; JAX kkt.py:191-216):

        [ d2L   0    Je   Ji ]
        [  0   Sig   0    -I ]        Sig = diag(lda_i / (s+guard))
        [ Je'   0    0     0 ]
        [ Ji'  -I    0     0 ]

    built as the upper triangle and mirrored, so a non-symmetric user d2f
    behaves as in the reference."""
    D, M, N = problem.nvar, problem.neq, problem.nineq
    K = D + 2 * N + M
    H = x.new_zeros((x.shape[0], K, K))
    H[:, :D, :D] = torch.triu(problem.hess_lagrangian(x, lda, p))
    if M:
        H[:, :D, D + N:D + N + M] = problem.jac_ce(x, p)
    if N:
        H[:, :D, D + N + M:] = problem.jac_ci(x, p)
        sig = lda[:, M:] / (s + _eps_of(x))
        H[:, D:D + N, D:D + N] = torch.diag_embed(sig)
        H[:, D:D + N, D + N + M:] = -torch.eye(N, dtype=x.dtype,
                                                device=x.device)
    return torch.triu(H) + torch.triu(H, 1).transpose(1, 2)


def phi(problem: Problem, x, s, mu, nu, p):
    """l1-penalty merit with log-barrier (reference pyipm.py:670-694):
    phi = f + nu*(|ce|_1 + |ci - s|_1) - mu*sum(log s).

    ``x``/``s`` may carry a trial axis, (B, W, D) / (B, W, N); ``mu`` and
    ``nu`` are (B,)."""
    val = problem.f_val(x, p)
    extra = (None,) * (x.dim() - 2)
    nu_ = nu[(slice(None),) + extra]
    mu_ = mu[(slice(None),) + extra]
    if problem.neq:
        val = val + nu_ * torch.sum(torch.abs(problem.ce_val(x, p)), dim=-1)
    if problem.nineq:
        val = val + nu_ * torch.sum(torch.abs(problem.ci_val(x, p) - s),
                                    dim=-1)
        val = val - mu_ * torch.sum(torch.log(s), dim=-1)
    return val


def dphi(problem: Problem, x, s, dz_xs, mu, nu, p):
    """Directional-derivative bound of phi along dz_xs = dz[:, :D+N]
    (reference pyipm.py:696-721)."""
    D = problem.nvar
    eps = _eps_of(x)
    val = _dot(problem.grad_f(x, p), dz_xs[:, :D])
    if problem.neq:
        val = val - nu * torch.sum(torch.abs(problem.ce_val(x, p)), dim=-1)
    if problem.nineq:
        val = val - nu * torch.sum(torch.abs(problem.ci_val(x, p) - s),
                                   dim=-1)
        val = val - _dot(mu[:, None] / (s + eps), dz_xs[:, D:])
    return val


def barrier_cost_grad(problem: Problem, x, s, mu, p):
    """[df(x); -mu/(s+guard)] (reference pyipm.py:746-763)."""
    gf = problem.grad_f(x, p)
    if problem.nineq:
        eps = _eps_of(x)
        return torch.cat([gf, -mu[:, None] / (s + eps)], dim=-1)
    return gf


def init_slack(problem: Problem, x, Ktol, p):
    """s0 = max(ci(x0), Ktol) (reference pyipm.py:732-744)."""
    c = problem.ci_val(x, p)
    return torch.clamp(c, min=Ktol)


def init_lambda(problem: Problem, x, Ktol, p):
    """Least-squares dual estimate pinv(jaco[:D]) @ df(x0), negative
    inequality multipliers clamped to Ktol (pyipm.py:723-730, 1612-1621)."""
    D, M, N = problem.nvar, problem.neq, problem.nineq
    J = jaco(problem, x, p)[:, :D, :]
    lda = lstsq_minnorm(J, problem.grad_f(x, p))
    if N:
        li = lda[:, M:]
        li = torch.where(li < 0, torch.full_like(li, Ktol), li)
        lda = torch.cat([lda[:, :M], li], dim=-1)
    return lda
