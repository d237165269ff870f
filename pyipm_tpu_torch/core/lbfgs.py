"""Compact-representation L-BFGS (Byrd-Nocedal-Schnabel), batch first
(counterpart of ``pyipm_tpu/core/lbfgs.py``).

The memory is a fixed (B, D, m) pair of arrays, m = lbfgs + 1, with a
per-instance count of valid columns: the reference's dynamically grown S/Y
FIFO-shift once they hold more than ``lbfgs`` pairs (pyipm.py:1300-1326).
Invalid rows and columns of every small system are pinned to the identity,
so all solves stay well-posed and contribute exactly zero.  Each
``lax.cond`` of the JAX package (accept / reject, grow / shift, reset) is a
``torch.where`` merge per instance.

The direction is the Woodbury form of pyipm.py:1032-1182: for constrained
problems the approximate Hessian Z - U M^-1 U' with
Z = [[diag(Adiag), B], [B', 0]] is inverted by a block inverse and the
Woodbury identity, so no (D+2N+M)^2 matrix is ever formed; unconstrained
problems take the classic compact inverse-Hessian product.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pyipm_tpu_torch.core import kkt as K
from pyipm_tpu_torch.core.problem import Problem
from pyipm_tpu_torch.ops.linalg import (
    SMALL_K, _eq_reg_term, ldlt_factor, matvec as _mv,
)
from pyipm_tpu_torch.ops.small_ldlt import ldlt_factor_small


class LBFGSState(NamedTuple):
    """Fixed-size L-BFGS memory, every field with a leading instance axis
    (reference lbfgs_init, pyipm.py:993-1005)."""
    zeta: torch.Tensor       # (B,) initial-Hessian scaling
    S: torch.Tensor          # (B, D, m) weight displacements
    Y: torch.Tensor          # (B, D, m) gradient displacements
    count: torch.Tensor      # (B,) int32 valid columns, in [0, m]
    fail: torch.Tensor       # (B,) int32 consecutive curvature failures


def lbfgs_init(B: int, nvar: int, mem: int, zeta0: float, dtype,
               device) -> LBFGSState:
    i32 = torch.zeros((B,), dtype=torch.int32, device=device)
    return LBFGSState(
        zeta=torch.full((B,), zeta0, dtype=dtype, device=device),
        S=torch.zeros((B, nvar, mem), dtype=dtype, device=device),
        Y=torch.zeros((B, nvar, mem), dtype=dtype, device=device),
        count=i32, fail=i32.clone())


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def lbfgs_update(state: LBFGSState, dx, dg, *, constrained: bool,
                 eps: float, zeta0: float, fail_max: int) -> LBFGSState:
    """Memory update with the curvature guard and the reset after too many
    failures (reference lbfgs_update, pyipm.py:1282-1371); dx, dg (B, D)."""
    m = state.S.shape[-1]
    eps_t = torch.as_tensor(eps, dtype=dx.dtype, device=dx.device)
    sqrt_eps = torch.sqrt(eps_t)
    dgdx = _dot(dg, dx)
    if constrained:
        zeta_new = dgdx / (_dot(dx, dx) + eps_t)      # pyipm.py:1293-1294
    else:
        zeta_new = dgdx / (_dot(dg, dg) + eps_t)      # pyipm.py:1295-1296
    good = (dgdx > sqrt_eps) & (zeta_new > sqrt_eps)  # pyipm.py:1297

    # accept: append at column ``count``, or shift left when full
    full = (state.count >= m)[:, None, None]
    col = torch.arange(m, device=dx.device)
    at = (col == state.count[:, None])[:, None, :]

    def insert(M_, v):
        shifted = torch.cat([M_[..., 1:], v[..., None]], dim=-1)
        grown = torch.where(at, v[..., None], M_)
        return torch.where(full, shifted, grown)

    g3 = good[:, None, None]
    S = torch.where(g3, insert(state.S, dx), state.S)
    Y = torch.where(g3, insert(state.Y, dg), state.Y)
    count = torch.where(good, torch.clamp(state.count + 1, max=m),
                        state.count)
    fail = torch.where(good, torch.zeros_like(state.fail), state.fail + 1)
    zeta = torch.where(good, zeta_new, state.zeta)

    # full reset after too many consecutive failures (pyipm.py:1363-1368)
    reset = (fail > fail_max) & (count > 0)
    r3 = reset[:, None, None]
    return LBFGSState(
        zeta=torch.where(reset, torch.full_like(zeta, zeta0), zeta),
        S=torch.where(r3, torch.zeros_like(S), S),
        Y=torch.where(r3, torch.zeros_like(Y), Y),
        count=torch.where(reset, torch.zeros_like(count), count),
        fail=torch.where(reset, torch.zeros_like(fail), fail))


def _masked_mem(state: LBFGSState, constrained: bool):
    """Masked S, Y and the compact middle matrices, per instance.

    constrained:   SS = S'S,  L = strict-lower(S'Y),  D = diag(S'Y)
                   (reference pyipm.py:1330-1345)
    unconstrained: SS holds Y'Y, L holds R = upper(S'Y) with its invalid
                   diagonal pinned to 1 (pyipm.py:1333-1334, 1347-1350)"""
    m = state.S.shape[-1]
    valid = torch.arange(m, device=state.S.device) < state.count[:, None]
    vm = valid.to(state.S.dtype)[:, None, :]
    Sm = state.S * vm
    Ym = state.Y * vm
    SY = Sm.transpose(1, 2) @ Ym
    Dv = torch.diagonal(SY, dim1=-2, dim2=-1)
    if constrained:
        SS = Sm.transpose(1, 2) @ Sm
        Lm = torch.tril(SY, -1)
    else:
        SS = Ym.transpose(1, 2) @ Ym
        Lm = torch.triu(SY) + torch.diag_embed((~valid).to(Sm.dtype))
    return Sm, Ym, SS, Lm, Dv, valid


def _padded_middle(SS, Lm, Dv, valid, zeta):
    """Minv = [[zeta SS, L], [L', -D]] with invalid rows and columns
    pinned to the identity (the reference builds it at the true size,
    pyipm.py:1086-1089)."""
    top = torch.cat([zeta[:, None, None] * SS, Lm], dim=-1)
    bot = torch.cat([Lm.transpose(1, 2), -torch.diag_embed(Dv)], dim=-1)
    pad = torch.cat([~valid, ~valid], dim=-1).to(SS.dtype)
    return torch.cat([top, bot], dim=-2) + torch.diag_embed(pad)


def _solve(A, b):
    """A x = b for (B, n, n), (B, n)."""
    return torch.linalg.solve(A, b.unsqueeze(-1)).squeeze(-1)


def eq_block_bump(G, mu, cfg):
    """The shift the eq block G (B, M, M) gets where it is ill-conditioned
    (reference pyipm.py:1106-1113): reg_coef eta mu^beta where the pivots
    of its unpivoted LDL^T (the same min|.|/max|.| signal as the
    reference's eigenvalues, by Sylvester's law: G = Je' diag(1/Adiag) Je
    is PSD) give rcond <= eps or are not finite, else 0.  The pivots come
    from the batched small factor (kernel 1) for M <= 128, from the blocked
    factor one instance at a time above.  Returns (bump, rcond)."""
    if G.shape[-1] <= SMALL_K:
        d = ldlt_factor_small(G.contiguous())[1]
    else:
        d = torch.stack([ldlt_factor(Gi, block=cfg.ldlt_block)[1]
                         for Gi in G])
    ad = torch.abs(d)
    rcond = (torch.amin(ad, dim=-1)
             / torch.clamp(torch.amax(ad, dim=-1),
                           min=torch.finfo(d.dtype).tiny))
    finite = torch.all(torch.isfinite(d), dim=-1)
    reg = _eq_reg_term(mu, cfg.reg_coef, cfg.eta, cfg.beta)
    bump = torch.where((rcond <= cfg.eps) | ~finite, reg,
                       torch.zeros_like(reg))
    return bump, rcond


def lbfgs_direction(problem: Problem, cfg, state: LBFGSState, x, s, lda, g,
                    mu, p):
    """Search direction dz (B, D+2N+M) for the current memory (reference
    lbfgs_builder, pyipm.py:1007-1182, and lbfgs_dir, pyipm.py:1184-1246).
    ``g`` is the NEGATED composite gradient (pyipm.py:1637, 1717)."""
    D, M, N = problem.nvar, problem.neq, problem.nineq
    zeta = state.zeta
    z3 = zeta[:, None, None]
    m = state.S.shape[-1]

    if not problem.ncon:
        # classic compact inverse-Hessian product (pyipm.py:1149-1175)
        Sm, Ym, YY, R, Dv, _ = _masked_mem(state, constrained=False)
        W = torch.cat([Sm, z3 * Ym], dim=-1)                  # (B, D, 2m)
        WT_g = _mv(W.transpose(1, 2), g)
        Bv = -_solve(R, WT_g[:, :m])
        RT = R.transpose(1, 2)
        A = (-_solve(RT, _mv(torch.diag_embed(Dv) + z3 * YY, Bv))
             - _solve(RT, WT_g[:, m:]))
        return zeta[:, None] * g + _mv(W, torch.cat([A, Bv], dim=-1))

    # constrained: block inverse of Z plus the Woodbury correction
    # (pyipm.py:1099-1148)
    Sm, Ym, SS, Lm, Dv, valid = _masked_mem(state, constrained=True)
    parts = [zeta[:, None].expand(-1, D)]
    if N:
        parts.append(lda[:, M:] / (s + K._eps_of(x)))
    Adiag = torch.cat(parts, dim=-1)                          # (B, D+N)
    Bj = K.jaco(problem, x, p)                                # (B, D+N, M+N)
    BjT = Bj.transpose(1, 2)
    g1 = g[:, :D + N]
    g2 = g[:, D + N:]
    BT_invA = BjT / Adiag[:, None, :]                         # (B, M+N, D+N)
    BT_invA_T = BT_invA.transpose(1, 2)
    mid = BT_invA @ Bj                                        # (B, M+N, M+N)
    if M:
        bump, _ = eq_block_bump(mid[:, :M, :M], mu, cfg)
        mid = mid.clone()
        dg = mid.diagonal(dim1=-2, dim2=-1)[:, :M]
        dg.copy_(dg + bump[:, None])

    # the (M+N)^2 block factored ONCE for the three solves below
    LU, piv = torch.linalg.lu_factor(mid)

    def solve_mid(rhs):
        return torch.linalg.lu_solve(LU, piv, rhs)

    v01 = solve_mid(_mv(BT_invA, g1).unsqueeze(-1)).squeeze(-1)
    v02 = g1 / Adiag - _mv(BT_invA_T, v01)
    v03 = -solve_mid(g2.unsqueeze(-1)).squeeze(-1)
    v04 = -_mv(BT_invA_T, v03)
    Zg = torch.cat([v02 + v04, v01 + v03], dim=-1)            # (B, K)

    W = torch.cat([z3 * Sm, Ym], dim=-1)                      # (B, D, 2m)
    if N:
        W = torch.cat([W, W.new_zeros((W.shape[0], N, 2 * m))], dim=-2)
    WT = W.transpose(1, 2)
    X00 = -solve_mid((BjT @ W) / z3)                          # (B, M+N, 2m)
    X01 = W / z3 + BT_invA_T @ X00                            # (B, D+N, 2m)
    Minv = _padded_middle(SS, Lm, Dv, valid, zeta)
    v11 = _solve(WT @ X01 - Minv, _mv(WT, Zg[:, :D + N]))
    X10 = torch.cat([X01, -X00], dim=-2)                      # (B, K, 2m)
    return Zg - _mv(X10, v11)
