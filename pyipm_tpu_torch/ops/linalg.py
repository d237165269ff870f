"""Inertia-corrected small KKT solves, batch first (counterpart of the
small-system subset of ``pyipm_tpu/ops/linalg.py``).

Every system here is a batch of (B, K, K) matrices with K <= 128, factored
by the batched LDL^T kernels of :mod:`pyipm_tpu_torch.ops.small_ldlt`.  The
JAX package's per-instance ``lax.while_loop``s (delta escalation, residual
gate) become host loops that refactor only the instances still looping;
the result for each instance is the one a single JAX solve computes.
The large-K path (blocked factorization, K > 128) is not ported yet.
"""

from __future__ import annotations

import torch

from pyipm_tpu_torch import _sync
from pyipm_tpu_torch.ops.small_ldlt import ldlt_factor_small, ldlt_solve_small

SMALL_K = 128


def matvec(A, v):
    """Batched matrix-vector product (B, m, n) @ (B, n) -> (B, m)."""
    return torch.matmul(A, v.unsqueeze(-1)).squeeze(-1)


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


def _tiny(dtype):
    return torch.finfo(dtype).tiny


def _scalar(v, like):
    """A Python number as a 0-dim tensor of ``like``'s dtype and device, so
    that products of constants round in the working dtype as in JAX."""
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def ldlt_inertia_ok(d, target_neg: int, eps):
    """Per-instance inertia/conditioning test on pivots d (B, n): finite,
    min|d|/max|d| > eps and exactly ``target_neg`` negative pivots
    (reference pyipm.py:1379-1381)."""
    ad = torch.abs(d)
    finite = torch.all(torch.isfinite(d), dim=-1)
    rcond = (torch.amin(ad, dim=-1)
             / torch.clamp(torch.amax(ad, dim=-1), min=_tiny(d.dtype)))
    neg = torch.sum(d < 0, dim=-1)
    return finite & (rcond > eps) & (neg == target_neg)


def ruiz_scale(H, iters: int = 3):
    """Symmetric Ruiz equilibration of (B, K, K): returns (D H D, d)."""
    d = H.new_ones(H.shape[:-1])
    Hs = H
    for _ in range(iters):
        r = torch.sqrt(torch.amax(torch.abs(Hs), dim=-1))
        r = torch.where(r > 0, r, torch.ones_like(r))
        Hs = Hs / r[..., :, None] / r[..., None, :]
        d = d / r
    return Hs, d


def _eq_reg_term(mu, reg_coef, eta, beta):
    """reg_coef * eta * max(mu, 0)**beta, per instance (pyipm.py:1388-1389)."""
    return (_scalar(reg_coef, mu) * _scalar(eta, mu)
            * torch.pow(torch.clamp(mu, min=0), _scalar(beta, mu)))


def _shifted(Hs, dlt, shift_diag, eq, eq_diag):
    """Hs + dlt*diag(shift_diag) - eq*diag(eq_diag), touching only the
    diagonal (the off-diagonal adds of exact zeros are no-ops)."""
    Hm = Hs.clone()
    dg = Hm.diagonal(dim1=-2, dim2=-1)
    dg.copy_((dg + dlt[:, None] * shift_diag) - eq[:, None] * eq_diag)
    return Hm


def reg_solve_kkt(H, g, delta, mu, *, nvar: int, neq: int, nineq: int,
                  eps: float, reg_coef: float, eta: float, beta: float,
                  delta0: float, max_retries: int = 40,
                  want_solver: bool = False):
    """Regularize each H for correct inertia and solve H dz = g
    (reference ``reghess``, pyipm.py:1373-1406; JAX ``_reg_solve_ldlt``
    small branch, linalg.py:862-1179).

    H (B, K, K), g (B, K), delta and mu (B,).  Returns
    (dz, delta_new, retries); with ``want_solver`` additionally a function
    solving further (B, K) right-hand sides against the final factors and
    the applied shifts (delta_applied, eq_applied), each (B,).
    """
    B, K, _ = H.shape
    if K > SMALL_K:
        raise NotImplementedError(
            f"reg_solve_kkt for K = {K} > {SMALL_K}: the blocked large-K "
            "path is ROADMAP Slice B (item 11), not ported yet")
    D, M, N = nvar, neq, nineq
    dtype, dev = H.dtype, H.device
    target = M + N
    idx = torch.arange(K, device=dev)
    ex = (idx < D).to(dtype)
    eeq = ((idx >= D + N) & (idx < D + N + M)).to(dtype)
    eps_t = _scalar(eps, H)
    delta0_t = _scalar(delta0, H)
    tiny = _tiny(dtype)

    Hs, dsc = ruiz_scale(H)
    shift_diag = (dsc * dsc) * ex
    eq_diag = (dsc * dsc) * eeq

    def scaled_solve(L_, d_, dsc_, rhs):
        return dsc_ * ldlt_solve_small(L_, d_, (dsc_ * rhs).contiguous())

    L, dv = ldlt_factor_small(Hs.contiguous())
    ok0 = ldlt_inertia_ok(dv, target, eps_t)
    if M:
        ad0 = torch.abs(dv)
        rcond0 = (torch.amin(ad0, dim=-1)
                  / torch.clamp(torch.amax(ad0, dim=-1), min=tiny))
        illcond0 = (~torch.all(torch.isfinite(dv), dim=-1)) | (rcond0 <= eps_t)
        reg = _eq_reg_term(mu, reg_coef, eta, beta)
        eq_applied = torch.where((~ok0) & illcond0, reg, torch.zeros_like(reg))
    else:
        eq_applied = H.new_zeros((B,))
    d1 = torch.where(delta == 0, delta0_t, torch.clamp(delta / 2, min=delta0))

    # delta escalation (linalg.py:1019-1039): entry on the full test
    # (~ok0), continuation on inertia alone; only looping instances refactor
    dlt = H.new_zeros((B,))
    t = torch.zeros((B,), dtype=torch.int32, device=dev)
    need = ~ok0 & (max_retries > 0)
    while True:
        ids = _sync.indices(need)
        if ids.numel() == 0:
            break
        t_s = t[ids]
        dlt_s = torch.where(t_s == 0, d1[ids], dlt[ids] * 10.0)
        L_s, d_s = ldlt_factor_small(_shifted(
            Hs[ids], dlt_s, shift_diag[ids], eq_applied[ids], eq_diag[ids]))
        L[ids] = L_s
        dv[ids] = d_s
        dlt[ids] = dlt_s
        t[ids] = t_s + 1
        bad = ((~torch.all(torch.isfinite(d_s), dim=-1))
               | (torch.sum(d_s < 0, dim=-1) != target))
        need = torch.zeros_like(need)
        need[ids] = bad & (t_s + 1 < max_retries)

    fixed = t > 0
    zero = H.new_zeros((B,))
    delta_new = torch.where(fixed, dlt, delta)
    delta_applied = torch.where(fixed, dlt, zero)
    retries = torch.clamp(t - 1, min=0)

    hnorm_H = torch.linalg.matrix_norm(H)
    sq_ex = torch.sqrt(torch.sum(ex))
    sq_eeq = torch.sqrt(torch.sum(eeq))

    def solve_refined(H_, g_, dsc_, L_, d_, dlt_a, eq_a, hnorm_):
        """Cached-factor solve + one guarded refinement step against the
        shifted system (linalg.py:1062-1104; the small path refines
        unconditionally).  Returns (y, residual norm, norm bound)."""
        def mv(y_):
            return (matvec(H_, y_) + dlt_a[:, None] * (ex * y_)
                    - eq_a[:, None] * (eeq * y_))

        hn = hnorm_ + dlt_a * sq_ex + eq_a * sq_eeq
        y = scaled_solve(L_, d_, dsc_, g_)
        r = g_ - mv(y)
        rn = _norm(r)
        y_new = y + scaled_solve(L_, d_, dsc_, r)
        rn_new = _norm(g_ - mv(y_new))
        better = rn_new < rn
        y = torch.where(better[:, None], y_new, y)
        rn = torch.where(better, rn_new, rn)
        return y, rn, hn

    dz, rn, Hnorm = solve_refined(H, g, dsc, L, dv, delta_applied,
                                  eq_applied, hnorm_H)

    # residual gate (linalg.py:1120-1157): escalate the primal shift while
    # the refined solve's normwise backward error exceeds sqrt(eps)
    gate_tol = torch.sqrt(eps_t)
    gnorm = _norm(g)

    def backward_err(rn_, dz_, Hn, gn):
        return rn_ / (Hn * _norm(dz_) + gn + tiny)

    d_gate = delta_applied.clone()
    t_gate = torch.zeros_like(t)
    need = (backward_err(rn, dz, Hnorm, gnorm) > gate_tol) & (max_retries > 0)
    while True:
        ids = _sync.indices(need)
        if ids.numel() == 0:
            break
        dg = d_gate[ids]
        dlt_s = torch.where(dg == 0, delta0_t, dg) * 10.0
        eq_s = eq_applied[ids]
        L_s, d_s = ldlt_factor_small(_shifted(
            Hs[ids], dlt_s, shift_diag[ids], eq_s, eq_diag[ids]))
        dz_s, rn_s, _ = solve_refined(H[ids], g[ids], dsc[ids], L_s, d_s,
                                      dlt_s, eq_s, hnorm_H[ids])
        L[ids] = L_s
        dv[ids] = d_s
        dz[ids] = dz_s
        d_gate[ids] = dlt_s
        tg = t_gate[ids] + 1
        t_gate[ids] = tg
        need = torch.zeros_like(need)
        need[ids] = ((backward_err(rn_s, dz_s, Hnorm[ids], gnorm[ids])
                      > gate_tol) & (tg < max_retries))

    gated = t_gate > 0
    delta_new = torch.where(gated, d_gate, delta_new)
    retries = retries + t_gate
    if not want_solver:
        return dz, delta_new, retries

    applied = (torch.where(gated, d_gate, delta_applied), eq_applied)

    def apply_factors(rhs):
        return scaled_solve(L, dv, dsc, rhs)

    return dz, delta_new, retries, apply_factors, applied


def lstsq_minnorm(A, b):
    """Minimum-norm least squares for (B, m, n), (B, m) -> (B, n), through
    lightly regularized normal equations with guarded refinement
    (JAX linalg.py:1372-1459)."""
    _, m, n = A.shape
    dtype = A.dtype
    reg = torch.sqrt(_scalar(torch.finfo(dtype).eps, A))

    def reg_solve(G, rhs, k):
        if k > SMALL_K:
            raise NotImplementedError(
                f"lstsq_minnorm with a {k}x{k} normal matrix: the large "
                "path is ROADMAP Slice B (item 11), not ported yet")
        diag = torch.diagonal(G, dim1=-2, dim2=-1)
        scale = torch.clamp(torch.sum(diag, dim=-1) / k, min=1.0)
        eye = torch.eye(k, dtype=dtype, device=A.device)
        Greg = G + (reg * scale)[:, None, None] * eye
        L, dv = ldlt_factor_small(Greg.contiguous())

        def solve(r_):
            return ldlt_solve_small(L, dv, r_.contiguous())

        y = solve(rhs)
        r = rhs - matvec(G, y)
        rn = _norm(r)
        # at most 3 steps; a rejected step ends an instance's refinement
        stalled = torch.zeros_like(rn, dtype=torch.bool)
        for _ in range(3):
            y1 = y + solve(r)
            r1 = rhs - matvec(G, y1)
            rn1 = _norm(r1)
            better = rn1 < rn
            upd = better & ~stalled
            y = torch.where(upd[:, None], y1, y)
            r = torch.where(upd[:, None], r1, r)
            rn = torch.where(upd, rn1, rn)
            stalled = stalled | ~better
        return y

    At = A.transpose(1, 2)
    if m <= n:
        return matvec(At, reg_solve(torch.matmul(A, At), b, m))
    return reg_solve(torch.matmul(At, A), matvec(At, b), n)
