"""Inertia-corrected KKT solves, batch first (counterpart of
``pyipm_tpu/ops/linalg.py``).

A batch of (B, K, K) systems is solved batch first, as the JAX package's
``vmap`` of its solve: small systems (K <= 128) by the batched LDL^T
kernels of :mod:`pyipm_tpu_torch.ops.small_ldlt`, larger ones by a
right-looking LDL^T over 128-wide panels whose (B, 128, 128) diagonal
panels go to the panel kernel of :mod:`pyipm_tpu_torch.ops.large_ldlt` in
one launch, solved by batched triangular solves.  The JAX package's
per-instance ``lax.while_loop``s (delta escalation, residual gate) become
host loops that refactor only the instances still looping; the result for
each instance is the one a single JAX solve computes.

One large system (B = 1, K > 128) takes the single-system blocked path:
the panel kernel on each diagonal panel, the inverses of the diagonal
panels or superblocks, and block substitution whose backward half is the
sweep kernel.  Each ``lax.cond`` and ``lax.while_loop`` of the JAX large
path is a host branch or loop whose condition goes through
:mod:`pyipm_tpu_torch._sync`.
"""

from __future__ import annotations

import torch

from pyipm_tpu_torch import _sync
from pyipm_tpu_torch.ops.large_ldlt import (
    MAX_PANEL, bwd_sweep_blocks, bwd_sweep_panels, panel_ldlt,
)
from pyipm_tpu_torch.ops.small_ldlt import ldlt_factor_small, ldlt_solve_small
from pyipm_tpu_torch.utils.profiling import annotate

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


def _shift_(Hm, dlt, shift_diag, eq, eq_diag):
    """Hm + dlt*diag(shift_diag) - eq*diag(eq_diag) in place, touching only
    the diagonal (the off-diagonal adds of exact zeros are no-ops)."""
    dg = Hm.diagonal(dim1=-2, dim2=-1)
    dg.copy_((dg + dlt[:, None] * shift_diag) - eq[:, None] * eq_diag)
    return Hm


def _shifted(Hs, dlt, shift_diag, eq, eq_diag):
    """:func:`_shift_` of a copy of Hs."""
    return _shift_(Hs.clone(), dlt, shift_diag, eq, eq_diag)


# ----------------------------------------------------------------------
# large-K blocked factorization and solves (one system, no batch axis)
def _safe(d):
    """Pivots with exact zeros replaced by 1 (the division guard)."""
    return torch.where(torch.abs(d) > 0, d, torch.ones_like(d))


def _solve_unit_lower(L, B):
    """L^-1 B for unit lower-triangular L (n, n) and B (n, r)."""
    return torch.linalg.solve_triangular(L, B, upper=False,
                                         unitriangular=True)


def unit_lower_inverse(L):
    """Exact inverse of unit lower-triangular (..., n, n) by log-depth
    nilpotent doubling, ~2 log2(n) matrix products (JAX
    linalg.py:260-273): with N = I - L, L^-1 = (I + N)(I + N^2)(I + N^4)..."""
    n = L.shape[-1]
    eye = torch.eye(n, dtype=L.dtype, device=L.device)
    N = eye - L
    P = eye + N
    M = N
    span = 2
    while span < n:
        M = M @ M
        P = P + P @ M
        span *= 2
    return P


def ldlt_factor(A, block: int = 128, rhs=None, pad_to=None,
                want_panels: bool = False):
    """Blocked right-looking unpivoted LDL^T of one (n, n) symmetric
    matrix, one trailing update per 128-wide panel (JAX linalg.py:64-240,
    its default per-block schedule).

    Pads to a multiple of ``block`` with an identity tail.  Each panel is
    factored by :func:`panel_ldlt`, the sub-panel rows by one triangular
    solve, and the trailing matrix is updated in place by one matrix
    product.  Returns (L, d), plus, with ``rhs``, the forward-substituted
    y = L^-1 rhs (the rhs rides each panel's triangular solve), plus, with
    ``want_panels``, the diagonal panels (out/block, block, block).  With
    ``pad_to`` (a multiple of ``block``, at least the padded size) L, d
    and y come out at that size with an identity tail, unsliced."""
    n = A.shape[0]
    if not 0 < block <= MAX_PANEL:
        raise ValueError(f"block = {block} not in 1..{MAX_PANEL} (the panel "
                         "kernel's limit)")
    nb = -(-n // block)
    npad = nb * block
    out = npad if pad_to is None else int(pad_to)
    if out < npad or out % block:
        raise ValueError(f"pad_to = {pad_to}: must be a multiple of {block} "
                         f"and at least {npad}")
    W = A.new_zeros((npad, npad))
    W[:n, :n] = A
    tail = torch.arange(n, npad, device=A.device)
    W[tail, tail] = 1
    with_rhs = rhs is not None
    if with_rhs:
        bt = A.new_zeros((npad,))
        bt[:n] = rhs
        y = A.new_zeros((out,))
    L = A.new_zeros((out, out))
    d = A.new_zeros((out,))
    if out > npad:
        tail = torch.arange(npad, out, device=A.device)
        L[tail, tail] = 1
        d[npad:] = 1
    if want_panels:
        panels = torch.eye(block, dtype=A.dtype, device=A.device).repeat(
            out // block, 1, 1)
    for k in range(nb):
        j0, j1 = k * block, (k + 1) * block
        Lkk, dk = panel_ldlt(W[j0:j1, j0:j1].contiguous())
        L[j0:j1, j0:j1] = Lkk
        d[j0:j1] = dk
        if want_panels:
            panels[k] = Lkk
        # sub-panel rows: Y = A21 Lkk^-T = L21 diag(dk); the rhs chunk
        # rides the same triangular solve as one more column
        rhs_cols = [W[j1:, j0:j1].T] + ([bt[j0:j1, None]] if with_rhs
                                        else [])
        X = _solve_unit_lower(Lkk, torch.cat(rhs_cols, dim=1))
        Y = X[:, :npad - j1].T
        L21 = Y / _safe(dk)
        L[j1:npad, j0:j1] = L21
        W[j1:, j1:].addmm_(L21, Y.T, alpha=-1)      # trailing update
        if with_rhs:
            yk = X[:, npad - j1]
            y[j0:j1] = yk
            bt[j1:] -= L21 @ yk
    outs = (L, d) if pad_to is not None else (L[:n, :n], d[:n])
    if with_rhs:
        outs = outs + ((y if pad_to is not None else y[:n]),)
    if want_panels:
        outs = outs + (panels,)
    return outs


def _grid(n: int, block: int, group: int):
    """(panels, group, superblocks, padded size) of the superblock grid."""
    nb = -(-n // block)
    g = max(1, min(int(group), nb))
    nb2 = -(-nb // g)
    return nb, g, nb2, nb2 * g * block


def ldlt_factor_panels(A, block: int = 128, group: int = 8, rhs=None):
    """:func:`ldlt_factor` padded to the superblock grid, plus the inverses
    of its 128-wide diagonal panels (JAX linalg.py:514-536).  Returns
    (Lp, dp, invp) or, with ``rhs``, (Lp, dp, invp, y)."""
    n = A.shape[0]
    if n <= block:
        raise ValueError(f"n = {n} <= block = {block}: not a blocked system")
    npad = _grid(n, block, group)[3]
    out = ldlt_factor(A, block=block, rhs=rhs, pad_to=npad, want_panels=True)
    invp = unit_lower_inverse(out[-1])
    return out[:2] + (invp,) + out[2:-1]


def ldlt_factor_blocks(A, block: int = 128, group: int = 4, rhs=None):
    """Like :func:`ldlt_factor`, plus the inverses of the unit-lower
    diagonal SUPERBLOCKS (npad/sb, sb, sb), sb = group*block, assembled
    from the panel inverses by blocked triangular inversion
    X_ij = -X_ii sum_{k=j}^{i-1} L_ik X_kj (JAX linalg.py:415-511, with
    ``pad_to_grid=True``).  Returns (L, d, invb) or, with ``rhs``, (L, d,
    invb, y), L, d and y padded to the superblock grid."""
    n = A.shape[0]
    if n <= block:
        raise ValueError(f"n = {n} <= block = {block}: not a blocked system")
    _, g, nb2, npad = _grid(n, block, group)
    out = ldlt_factor(A, block=block, rhs=rhs, pad_to=npad, want_panels=True)
    L, d = out[:2]
    tail = out[2:3] if rhs is not None else ()
    invp = unit_lower_inverse(out[-1])                 # (P, block, block)
    if g == 1:
        return (L, d, invp) + tail
    # Lsub[m, i, :, k, :] = the (m*g+i, m*g+k) panel block of L
    Lsub = L.view(nb2, g, block, nb2, g, block).diagonal(
        dim1=0, dim2=3).permute(4, 0, 1, 2, 3)
    inv4 = invp.view(nb2, g, block, block)
    X = [[None] * g for _ in range(g)]
    for i in range(g):
        X[i][i] = inv4[:, i]
    for i in range(1, g):
        for j in range(i - 1, -1, -1):
            acc = Lsub[:, i, :, j, :] @ X[j][j]
            for k in range(j + 1, i):
                acc = acc + Lsub[:, i, :, k, :] @ X[k][j]
            X[i][j] = -(inv4[:, i] @ acc)
    invb = L.new_zeros((nb2, g, block, g, block))
    for i in range(g):
        for j in range(i + 1):
            invb[:, i, :, j, :] = X[i][j]
    return (L, d, invb.view(nb2, g * block, g * block)) + tail


def _pad_vec(v, npad: int, fill: float = 0.0):
    out = v.new_full((npad,), fill)
    out[:v.shape[0]] = v
    return out


def _fwd_sweep(Lp, inv, b):
    """y with L y = b by block forward substitution at the block width of
    ``inv`` (nsteps, w, w): y_k = inv_k (b_k - Lp[kw:(k+1)w, :kw] y[:kw])
    (JAX ``_fwd_sweep_panels_xla``, the ``fwd`` loop of
    ``ldlt_solve_blocks``)."""
    nsteps, w, _ = inv.shape
    y = torch.zeros_like(b)
    for k in range(nsteps):
        j0, j1 = k * w, (k + 1) * w
        y[j0:j1] = inv[k] @ (b[j0:j1] - Lp[j0:j1, :j0] @ y[:j0])
    return y


def ldlt_solve_blocks(Lp, dp, invb, b):
    """(L diag(d) L^T) x = b from :func:`ldlt_factor_blocks` factors
    (padded to the grid of ``invb``): forward block substitution,
    diagonal scale, the backward sweep kernel."""
    z = _fwd_sweep(Lp, invb, _pad_vec(b, Lp.shape[0])) / _safe(dp)
    return bwd_sweep_blocks(Lp, z, invb)[:b.shape[0]]


def ldlt_solve_blocks_bwd(Lp, dp, invb, y):
    """Finish a solve whose forward substitution came folded out of the
    factorization: diagonal scale + the backward superblock sweep.  Lp, dp
    padded to the grid, y (n,); returns (n,)."""
    npad = Lp.shape[0]
    z = _pad_vec(y, npad) / _safe(dp)
    return bwd_sweep_blocks(Lp, z, invb)[:y.shape[0]]


def ldlt_solve_panels(Lp, dp, invp, b):
    """(L diag(d) L^T) x = b from panel-grid factors: forward panel
    substitution, diagonal scale, the backward panel sweep kernel."""
    npad = Lp.shape[0]
    z = _fwd_sweep(Lp, invp, _pad_vec(b, npad)) / _safe(dp)
    return bwd_sweep_panels(Lp, z, invp)[:b.shape[0]]


def ldlt_solve_panels_bwd(Lp, dp, invp, y):
    """Diagonal scale + backward panel sweep of a fwd-folded y (n,);
    returns the padded (npad,) solution, as the JAX function does."""
    z = _pad_vec(y, Lp.shape[0]) / _safe(dp)
    return bwd_sweep_panels(Lp, z, invp)


def _reg_solve_large(H, g, delta, mu, *, nvar, neq, nineq, eps, reg_coef,
                     eta, beta, delta0, max_retries, block, group, ir_steps,
                     want_solver):
    """``reg_solve_kkt`` for ONE system with K > 128 (JAX
    ``_reg_solve_ldlt`` large branch, linalg.py:896-1179): H (K, K), g
    (K,), delta and mu 0-dim.

    ``want_solver`` keeps the superblock inverses (factor once, solve many:
    the condensed direction) and sweeps with ``bwd_sweep_blocks``; the
    single-shot form keeps only the panel inverses and sweeps with
    ``bwd_sweep_panels``.  The main rhs rides the factorization, so its
    first solve is only the backward sweep."""
    D, M, N = nvar, neq, nineq
    K = H.shape[0]
    dtype, dev = H.dtype, H.device
    target = M + N
    idx = torch.arange(K, device=dev)
    ex = (idx < D).to(dtype)
    eeq = ((idx >= D + N) & (idx < D + N + M)).to(dtype)
    eps_t = _scalar(eps, H)
    delta0_t = _scalar(delta0, H)
    tiny = _tiny(dtype)
    zero = H.new_zeros(())

    Hs, dsc = ruiz_scale(H[None])
    Hs, dsc = Hs[0], dsc[0]
    shift_diag = (dsc * dsc) * ex
    eq_diag = (dsc * dsc) * eeq
    rhs_fold = dsc * g

    if want_solver:
        factor_fn, solve_fn, bwd_fn = (ldlt_factor_blocks, ldlt_solve_blocks,
                                       ldlt_solve_blocks_bwd)
    else:
        factor_fn, solve_fn, bwd_fn = (ldlt_factor_panels, ldlt_solve_panels,
                                       ldlt_solve_panels_bwd)

    def factor(Hm):
        with annotate("ipm-kkt-factor", dev):
            return factor_fn(Hm, block=block, group=group, rhs=rhs_fold)

    def first_solve(f):
        with annotate("ipm-kkt-solve", dev):
            return dsc * bwd_fn(f[0], f[1], f[2], f[3])[:K]

    def scaled_solve(f, rhs):
        with annotate("ipm-kkt-solve", dev):
            return dsc * solve_fn(f[0], f[1], f[2], dsc * rhs)

    def shifted(dlt, eq):
        Hm = Hs.clone()
        dg = Hm.diagonal()
        dg.copy_((dg + dlt * shift_diag) - eq * eq_diag)
        return Hm

    def bad_inertia(f):
        dv = f[1][:K]
        return ((~torch.all(torch.isfinite(dv)))
                | (torch.sum(dv < 0) != target))

    facs = factor(Hs)
    d0 = facs[1][:K]
    ok0 = ldlt_inertia_ok(d0[None], target, eps_t)[0]
    if M:
        ad0 = torch.abs(d0)
        rcond0 = torch.amin(ad0) / torch.clamp(torch.amax(ad0), min=tiny)
        illcond0 = (~torch.all(torch.isfinite(d0))) | (rcond0 <= eps_t)
        reg = _eq_reg_term(mu, reg_coef, eta, beta)
        eq_applied = torch.where((~ok0) & illcond0, reg, zero)
    else:
        eq_applied = zero
    d1 = torch.where(delta == 0, delta0_t, torch.clamp(delta / 2, min=delta0))

    # delta escalation (linalg.py:1019-1047): entry on the full test,
    # continuation on inertia alone
    dlt, t = zero, 0
    need = ~ok0
    while t < max_retries and _sync.any_true(need):
        dlt = d1 if t == 0 else dlt * 10.0
        facs = None                   # free the old factors first
        facs = factor(shifted(dlt, eq_applied))
        t += 1
        need = bad_inertia(facs)
    delta_new = dlt if t else delta
    delta_applied = dlt if t else zero
    retries = max(t - 1, 0)

    # solve + guarded refinement, skipped when the unrefined backward
    # error is already below eps^0.75 (linalg.py:1050-1104)
    ir_skip_tol = eps ** 0.75
    hnorm_H = torch.linalg.matrix_norm(H)
    sq_ex = torch.sqrt(torch.sum(ex))
    sq_eeq = torch.sqrt(torch.sum(eeq))

    def solve_refined(f, dlt_a, eq_a):
        def mv(y_):
            return H @ y_ + dlt_a * (ex * y_) - eq_a * (eeq * y_)

        hn = hnorm_H + dlt_a * sq_ex + eq_a * sq_eeq
        y = first_solve(f)
        r = g - mv(y)
        rn = torch.linalg.vector_norm(r)
        need = rn > ir_skip_tol * (hn * torch.linalg.vector_norm(y)
                                   + torch.linalg.vector_norm(g) + tiny)
        if _sync.any_true(need):
            for _ in range(max(ir_steps, 1)):
                y_new = y + scaled_solve(f, r)
                r_new = g - mv(y_new)
                rn_new = torch.linalg.vector_norm(r_new)
                better = rn_new < rn
                y = torch.where(better, y_new, y)
                r = torch.where(better, r_new, r)
                rn = torch.where(better, rn_new, rn)
        return y, rn, hn

    dz, rn, Hnorm = solve_refined(facs, delta_applied, eq_applied)

    # residual gate (linalg.py:1110-1179)
    gate_tol = torch.sqrt(eps_t)
    gnorm = torch.linalg.vector_norm(g)

    def gate_needed(rn_, dz_):
        bkw = rn_ / (Hnorm * torch.linalg.vector_norm(dz_) + gnorm + tiny)
        return bkw > gate_tol

    d_gate, t_gate = delta_applied, 0
    while t_gate < max_retries and _sync.any_true(gate_needed(rn, dz)):
        d_gate = torch.where(d_gate == 0, delta0_t, d_gate) * 10.0
        facs = None
        facs = factor(shifted(d_gate, eq_applied))
        dz, rn, _ = solve_refined(facs, d_gate, eq_applied)
        t_gate += 1
    if t_gate:
        delta_new = d_gate
    retries = torch.tensor(retries + t_gate, dtype=torch.int32, device=dev)
    if not want_solver:
        return dz, delta_new, retries

    def apply_factors(rhs):
        return scaled_solve(facs, rhs)

    return dz, delta_new, retries, apply_factors, (d_gate, eq_applied)


def _reg_solve_eigh(H, g, delta, mu, *, nvar, neq, nineq, eps, reg_coef,
                    eta, beta, delta0, max_retries):
    """The reference's own flow (JAX ``_reg_solve_eigh``, linalg.py:
    793-841): inertia from the eigenvalues of H, the eq-block shift where
    H is ill-conditioned, delta escalated x10 while the inertia is wrong,
    then a dense LU solve.  Only the instances with bad inertia or
    conditioning loop."""
    D, M, N = nvar, neq, nineq
    B, K, _ = H.shape
    dev = H.device
    target = M + N
    idx = torch.arange(K, device=dev)
    ex = (idx < D).to(H.dtype)
    eeq = ((idx >= D + N) & (idx < D + N + M)).to(H.dtype)
    eps_t = _scalar(eps, H)
    delta0_t = _scalar(delta0, H)
    tiny = _tiny(H.dtype)

    def inertia(Hm):
        w = torch.linalg.eigvalsh(Hm)
        aw = torch.abs(w)
        rcond = (torch.amin(aw, dim=-1)
                 / torch.clamp(torch.amax(aw, dim=-1), min=tiny))
        return rcond, torch.sum(w < -eps_t, dim=-1)

    rcond0, neg0 = inertia(H)
    bad = (rcond0 <= eps_t) | (neg0 != target)
    Hf = H.clone()
    delta_new = delta.clone()
    retries = torch.zeros((B,), dtype=torch.int32, device=dev)
    ids = _sync.indices(bad)
    if ids.numel():
        Hb = H[ids]
        # the eq-block shift where H is ill-conditioned; ex and eeq are
        # disjoint, so one diagonal update per trial is JAX's two adds
        eq = torch.zeros_like(rcond0[ids])
        if M:
            eq = torch.where(rcond0[ids] <= eps_t,
                             _eq_reg_term(mu[ids], reg_coef, eta, beta), eq)
        dl = delta[ids]
        dlt = torch.where(dl == 0, delta0_t, torch.clamp(dl / 2, min=delta0))
        t = torch.zeros_like(retries[ids])
        neg = inertia(_shifted(Hb, dlt, ex, eq, eeq))[1]
        # escalation (linalg.py:818-827): only the instances still looping
        while True:
            loop = _sync.indices((neg != target) & (t < max_retries))
            if loop.numel() == 0:
                break
            dlt[loop] = dlt[loop] * 10.0
            t[loop] += 1
            neg[loop] = inertia(_shifted(Hb[loop], dlt[loop], ex, eq[loop],
                                         eeq))[1]
        Hf[ids] = _shifted(Hb, dlt, ex, eq, eeq)
        delta_new[ids] = dlt
        retries[ids] = t
    dz = torch.linalg.solve(Hf, g.unsqueeze(-1)).squeeze(-1)
    return dz, delta_new, retries


def reg_solve_kkt(H, g, delta, mu, *, nvar: int, neq: int, nineq: int,
                  eps: float, reg_coef: float, eta: float, beta: float,
                  delta0: float, max_retries: int = 40,
                  want_solver: bool = False, block: int = 128,
                  group: int = 8, ir_steps: int = 1, method: str = "ldlt"):
    """Regularize each H for correct inertia and solve H dz = g
    (reference ``reghess``, pyipm.py:1373-1406; JAX ``_reg_solve_ldlt``,
    linalg.py:862-1179).

    H (B, K, K), g (B, K), delta and mu (B,).  Returns
    (dz, delta_new, retries); with ``want_solver`` additionally a function
    solving further (B, K) right-hand sides against the final factors and
    the applied shifts (delta_applied, eq_applied), each (B,).  A batch
    takes :func:`_reg_solve_batched` (K > 128 with ``block``-wide panels
    and ``ir_steps``); one system with K > 128 takes
    :func:`_reg_solve_large` (``block``, ``group``, ``ir_steps``).
    ``method='lu'`` takes the reference's eigenvalue-inertia flow and an
    LU solve instead (no ``want_solver``).
    """
    B, K, _ = H.shape
    kw = dict(nvar=nvar, neq=neq, nineq=nineq, eps=eps, reg_coef=reg_coef,
              eta=eta, beta=beta, delta0=delta0, max_retries=max_retries)
    if method == "lu":
        if want_solver:
            raise ValueError("method='lu' keeps no factors (want_solver)")
        return _reg_solve_eigh(H, g, delta, mu, **kw)
    if method != "ldlt":
        raise ValueError(f"unknown method {method!r}")
    if K <= SMALL_K or B > 1:
        return _reg_solve_batched(H, g, delta, mu, block=block,
                                  ir_steps=ir_steps, want_solver=want_solver,
                                  **kw)
    out = _reg_solve_large(H[0], g[0], delta[0], mu[0], block=block,
                           group=group, ir_steps=ir_steps,
                           want_solver=want_solver, **kw)
    dz, delta_new, retries = (torch.stack([o]) for o in out[:3])
    if not want_solver:
        return dz, delta_new, retries
    solve_one = out[3]

    def apply_one(rhs):
        return torch.stack([solve_one(rhs[0])])

    return (dz, delta_new, retries, apply_one,
            tuple(torch.stack([a]) for a in out[4]))


def _ldlt_solve_padded(L, d, b):
    """(L diag(d) L^T) x = b for B padded factors (B, npad, npad), (B,
    npad) of :func:`ldlt_factor_batched` and b (B, K), K <= npad: two
    batched triangular solves on the zero-padded right-hand side (the
    identity tail of the factors keeps the padding zero)."""
    Bb, npad, _ = L.shape
    K = b.shape[-1]
    bp = b.new_zeros((Bb, npad, 1))
    bp[:, :K, 0] = b
    y = torch.linalg.solve_triangular(L, bp, upper=False, unitriangular=True)
    z = y / _safe(d)[..., None]
    x = torch.linalg.solve_triangular(L.transpose(1, 2), z, upper=True,
                                      unitriangular=True)
    return x[:, :K, 0]


def _reg_solve_batched(H, g, delta, mu, *, nvar, neq, nineq, eps, reg_coef,
                       eta, beta, delta0, max_retries, block, ir_steps,
                       want_solver):
    """``reg_solve_kkt`` of a batch: the JAX ``_reg_solve_ldlt`` under
    ``vmap``, decision for decision per instance.  K <= 128: kernel 1 and
    kernel 2 (the solve with the Ruiz scale fused), refinement always.
    K > 128: :func:`ldlt_factor_batched` (kernel 3 on the batch of
    diagonal panels) padded to a multiple of ``block``, batched triangular
    solves on the padded factors, refinement only where the unrefined
    backward error exceeds eps^0.75 (the JAX large path's ``lax.cond``,
    a select under ``vmap``).  The per-instance ``lax.while_loop``s
    (escalation, residual gate) are host loops that refactor only the
    instances still looping, gathered by one host sync a round for the
    whole batch."""
    D, M, N = nvar, neq, nineq
    B, K, _ = H.shape
    dtype, dev = H.dtype, H.device
    target = M + N
    idx = torch.arange(K, device=dev)
    ex = (idx < D).to(dtype)
    eeq = ((idx >= D + N) & (idx < D + N + M)).to(dtype)
    eps_t = _scalar(eps, H)
    delta0_t = _scalar(delta0, H)
    tiny = _tiny(dtype)
    wide = K > SMALL_K

    Hs, dsc = ruiz_scale(H)
    shift_diag = (dsc * dsc) * ex
    eq_diag = (dsc * dsc) * eeq

    if wide:
        def factor(Hm):
            with annotate("ipm-kkt-factor", dev):
                return ldlt_factor_batched(Hm, block=block, padded=True)

        def scaled_solve(L_, d_, dsc_, rhs):
            with annotate("ipm-kkt-solve", dev):
                return dsc_ * _ldlt_solve_padded(L_, d_, dsc_ * rhs)
    else:
        def factor(Hm):
            with annotate("ipm-kkt-factor", dev):
                return ldlt_factor_small(Hm.contiguous())

        def scaled_solve(L_, d_, dsc_, rhs):
            with annotate("ipm-kkt-solve", dev):
                return ldlt_solve_small(L_, d_, rhs.contiguous(), scale=dsc_)

    def bad_inertia(d_):
        dv_ = d_[:, :K]
        return ((~torch.all(torch.isfinite(dv_), dim=-1))
                | (torch.sum(dv_ < 0, dim=-1) != target))

    L, dv = factor(Hs)
    d0 = dv[:, :K]
    ok0 = ldlt_inertia_ok(d0, target, eps_t)
    if M:
        ad0 = torch.abs(d0)
        rcond0 = (torch.amin(ad0, dim=-1)
                  / torch.clamp(torch.amax(ad0, dim=-1), min=tiny))
        illcond0 = (~torch.all(torch.isfinite(d0), dim=-1)) | (rcond0 <= eps_t)
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
        # the gathered rows are a copy: shifted in place
        L_s, d_s = factor(_shift_(Hs[ids], dlt_s, shift_diag[ids],
                                  eq_applied[ids], eq_diag[ids]))
        L[ids] = L_s
        dv[ids] = d_s
        dlt[ids] = dlt_s
        t[ids] = t_s + 1
        need = torch.zeros_like(need)
        need[ids] = bad_inertia(d_s) & (t_s + 1 < max_retries)
        del L_s

    fixed = t > 0
    zero = H.new_zeros((B,))
    delta_new = torch.where(fixed, dlt, delta)
    delta_applied = torch.where(fixed, dlt, zero)
    retries = torch.clamp(t - 1, min=0)

    hnorm_H = torch.linalg.matrix_norm(H)
    sq_ex = torch.sqrt(torch.sum(ex))
    sq_eeq = torch.sqrt(torch.sum(eeq))
    ir_skip_tol = eps ** 0.75

    def solve_refined(H_, g_, dsc_, L_, d_, dlt_a, eq_a, hnorm_):
        """Cached-factor solve + guarded refinement against the shifted
        system (linalg.py:1050-1104), each step kept only where it lowers
        the residual; K > 128 refines only where the unrefined backward
        error exceeds eps^0.75.  Returns (y, residual norm, norm bound)."""
        def mv(y_):
            return (matvec(H_, y_) + dlt_a[:, None] * (ex * y_)
                    - eq_a[:, None] * (eeq * y_))

        hn = hnorm_ + dlt_a * sq_ex + eq_a * sq_eeq
        y = scaled_solve(L_, d_, dsc_, g_)
        r = g_ - mv(y)
        rn = _norm(r)
        keep = None
        if wide:
            keep = rn > ir_skip_tol * (hn * _norm(y) + _norm(g_) + tiny)
            if not _sync.any_true(keep):
                return y, rn, hn
        for _ in range(max(ir_steps, 1)):
            y_new = y + scaled_solve(L_, d_, dsc_, r)
            r_new = g_ - mv(y_new)
            rn_new = _norm(r_new)
            better = rn_new < rn
            if keep is not None:
                better = better & keep
            y = torch.where(better[:, None], y_new, y)
            r = torch.where(better[:, None], r_new, r)
            rn = torch.where(better, rn_new, rn)
        return y, rn, hn

    dz, rn, Hnorm = solve_refined(H, g, dsc, L, dv, delta_applied,
                                  eq_applied, hnorm_H)

    # residual gate (linalg.py:1110-1179): escalate the primal shift while
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
        L_s, d_s = factor(_shift_(Hs[ids], dlt_s, shift_diag[ids], eq_s,
                                  eq_diag[ids]))
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
        del L_s

    gated = t_gate > 0
    delta_new = torch.where(gated, d_gate, delta_new)
    retries = retries + t_gate
    if not want_solver:
        return dz, delta_new, retries

    applied = (torch.where(gated, d_gate, delta_applied), eq_applied)

    def apply_factors(rhs):
        return scaled_solve(L, dv, dsc, rhs)

    return dz, delta_new, retries, apply_factors, applied


# ----------------------------------------------------------------------
# batches of mid-size and large blocks (the Schur solver's per-block
# systems, JAX linalg.py:276-393 and :1183-1367)
def ldlt_factor_unrolled(A, panel: int = 16, want_panel_inv: bool = False):
    """Batched LDL^T of (B, n, n) over ``panel``-wide panels: each panel
    factored by ``panel`` masked elementwise column steps on (B, p, p), its
    sub-panel rows by one product with the panel's inverse, the trailing
    matrix by one batched product (JAX linalg.py:276-346).  Returns (L, d)
    and, with ``want_panel_inv``, the panel inverses (B, nb, p, p) for
    :func:`ldlt_solve_unrolled_blocks`.  Plain PyTorch: the JAX package
    computes it outside any kernel too."""
    Bb, n, _ = A.shape

    def factor_panel(Ap):
        p = Ap.shape[-1]
        rows = torch.arange(p, device=Ap.device)
        zero = Ap.new_zeros(())
        cols, ds = [], []
        for j in range(p):
            dj = Ap[:, j, j]
            col = Ap[:, :, j] / _safe(dj)[:, None]
            col = torch.where(rows[None, :] > j, col, zero)
            cols.append(col + (rows == j)[None, :].to(Ap.dtype))
            ds.append(dj)
            Ap = Ap - col[:, :, None] * col[:, None, :] * dj[:, None, None]
        return torch.stack(cols, dim=-1), torch.stack(ds, dim=-1)

    if n <= panel:
        L, dv = factor_panel(A)
        if want_panel_inv:
            return L, dv, unit_lower_inverse(L)[:, None]
        return L, dv
    nb = -(-n // panel)
    npad = nb * panel
    At = _pad_identity(A, npad)
    L = A.new_zeros((Bb, npad, npad))
    d = A.new_zeros((Bb, npad))
    invs = A.new_empty((Bb, nb, panel, panel))
    for k in range(nb):
        j0, j1 = k * panel, (k + 1) * panel
        L11, dk = factor_panel(At[:, :panel, :panel])
        L11inv = unit_lower_inverse(L11)
        Y = At[:, panel:, :panel] @ L11inv.transpose(-1, -2)  # = L21 d
        L21 = Y / _safe(dk)[:, None, :]
        At = At[:, panel:, panel:] - L21 @ Y.transpose(-1, -2)
        L[:, j0:j1, j0:j1] = L11
        L[:, j1:, j0:j1] = L21
        d[:, j0:j1] = dk
        invs[:, k] = L11inv
    if want_panel_inv:
        return L[:, :n, :n], d[:, :n], invs
    return L[:, :n, :n], d[:, :n]


def ldlt_solve_unrolled_blocks(L, d, invb, Bc, panel: int):
    """(L diag(d) L^T) X = Bc for (B, n, n), (B, n), the panel inverses
    (B, nb, p, p) of :func:`ldlt_factor_unrolled` and a multi-rhs Bc
    (B, n, r): block forward substitution, the diagonal scale, block
    backward substitution, one batched product per panel step (JAX
    linalg.py:347-393)."""
    Bb, n, r = Bc.shape
    nb = invb.shape[1]
    npad = nb * panel
    if npad != n:
        L = _pad_identity(L, npad)
        d = torch.cat([d, d.new_ones((Bb, npad - n))], dim=1)
        Bc = torch.cat([Bc, Bc.new_zeros((Bb, npad - n, r))], dim=1)
    y = Bc.new_empty((Bb, npad, r))
    for k in range(nb):
        j0, j1 = k * panel, (k + 1) * panel
        bk = Bc[:, j0:j1]
        if k:
            bk = bk - L[:, j0:j1, :j0] @ y[:, :j0]
        y[:, j0:j1] = invb[:, k] @ bk
    z = y / _safe(d)[..., None]
    x = Bc.new_empty((Bb, npad, r))
    for k in reversed(range(nb)):
        j0, j1 = k * panel, (k + 1) * panel
        zk = z[:, j0:j1]
        if k < nb - 1:
            zk = zk - L[:, j1:, j0:j1].transpose(1, 2) @ x[:, j1:]
        x[:, j0:j1] = invb[:, k].transpose(1, 2) @ zk
    return x[:, :n]


def _pad_identity(A, npad: int):
    """(B, n, n) padded to (B, npad, npad) with an identity tail."""
    Bb, n, _ = A.shape
    if npad == n:
        return A
    W = A.new_zeros((Bb, npad, npad))
    W[:, :n, :n] = A
    tail = torch.arange(n, npad, device=A.device)
    W[:, tail, tail] = 1
    return W


def ldlt_factor_batched(A, block: int = 128, padded: bool = False):
    """Blocked right-looking LDL^T of B blocks (B, n, n), n > ``block``, in
    one pass over the ``block``-wide panels (the JAX package's
    ``vmap(ldlt_factor)``, linalg.py:1266): per panel step one launch of
    the panel kernel on the (B, block, block) diagonal panels, one batched
    triangular solve for the sub-panel rows, one batched trailing product.
    Pads to a multiple of ``block`` with an identity tail, as
    :func:`ldlt_factor`, and builds L in place of the working copy.
    Returns (L, d), (B, n, n) and (B, n), or with ``padded`` the padded
    (B, npad, npad) and (B, npad)."""
    Bb, n, _ = A.shape
    if not 0 < block <= MAX_PANEL:
        raise ValueError(f"block = {block} not in 1..{MAX_PANEL} (the panel "
                         "kernel's limit)")
    nb = -(-n // block)
    npad = nb * block
    W = _pad_identity(A, npad)
    if W is A:
        W = A.clone()
    d = A.new_zeros((Bb, npad))
    for k in range(nb):
        j0, j1 = k * block, (k + 1) * block
        Lkk, dk = panel_ldlt(W[:, j0:j1, j0:j1].contiguous())
        W[:, j0:j1, j0:j1] = Lkk
        d[:, j0:j1] = dk
        if j1 == npad:
            break
        # sub-panel rows: Y = A21 Lkk^-T = L21 diag(dk)
        Y = torch.linalg.solve_triangular(
            Lkk, W[:, j1:, j0:j1].transpose(1, 2), upper=False,
            unitriangular=True).transpose(1, 2)
        L21 = Y / _safe(dk)[:, None, :]
        W[:, j1:, j1:].baddbmm_(L21, Y.transpose(1, 2), alpha=-1)
        W[:, j1:, j0:j1] = L21
        W[:, j0:j1, j1:] = 0
    if padded:
        return W, d
    return W[:, :n, :n], d[:, :n]


def batched_reg_factor(H, delta, mu, *, neq: int, eps: float,
                       reg_coef: float, eta: float, beta: float,
                       delta0: float, max_retries: int = 40,
                       block: int = 128):
    """Batched inertia-corrected LDL^T of the (B, n, n) per-block condensed
    systems of the Schur solver, layout [x block (n - neq); eq block (neq)],
    target inertia ``neq`` negative pivots (JAX linalg.py:1183-1367),
    decision for decision: Ruiz scaling per block, pivot-sign inertia with
    the rcond test, the eq-block regularization on ill-conditioned blocks,
    the warm-started per-block delta (B,), the x10 escalation over the bad
    blocks only (good blocks keep their first factors), the whole retry
    phase skipped when every block is good.

    Three branches by n: n <= 128 the batched small factor (kernel 1) and
    one ``unit_lower_inverse`` reused by every solve; n <= 512
    :func:`ldlt_factor_unrolled` with panel 32; above,
    :func:`ldlt_factor_batched` (kernel 3 on the batch of panels) and two
    batched triangular solves.

    Host syncs (``_sync``): one for the skip test, one per escalation
    test.  Returns ``(solve_fn, delta_new, retries, (delta_applied,
    eq_shift))``: ``solve_fn(Bc (B, n, r))`` solves against the final
    factors in the original (unscaled) coordinates; ``retries`` an int."""
    Bn, n, _ = H.shape
    dtype, dev = H.dtype, H.device
    d_x = n - neq
    idx = torch.arange(n, device=dev)
    ex = (idx < d_x).to(dtype)
    eeq = (idx >= d_x).to(dtype)
    eps_t = _scalar(eps, H)
    delta0_t = _scalar(delta0, H)
    tiny = _tiny(dtype)

    Hs, dsc = ruiz_scale(H)
    shift_diag = (dsc * dsc) * ex
    eq_diag = (dsc * dsc) * eeq

    if n <= SMALL_K:
        def factor(Hm):
            with annotate("ipm-kkt-factor", dev):
                L, dv = ldlt_factor_small(Hm.contiguous())
                return L, dv, unit_lower_inverse(L)

        def fsolve(facs, Bc):
            _, dv, Linv = facs
            z = (Linv @ Bc) / _safe(dv)[..., None]
            return Linv.transpose(1, 2) @ z
    elif n <= 512:
        def factor(Hm):
            with annotate("ipm-kkt-factor", dev):
                return ldlt_factor_unrolled(Hm, panel=32,
                                            want_panel_inv=True)

        def fsolve(facs, Bc):
            return ldlt_solve_unrolled_blocks(*facs, Bc, panel=32)
    else:
        def factor(Hm):
            with annotate("ipm-kkt-factor", dev):
                return ldlt_factor_batched(Hm, block=block)

        def fsolve(facs, Bc):
            L, dv = facs
            y = torch.linalg.solve_triangular(L, Bc, upper=False,
                                              unitriangular=True)
            z = y / _safe(dv)[..., None]
            return torch.linalg.solve_triangular(
                L.transpose(1, 2), z, upper=True, unitriangular=True)

    def shift_ok(dv):
        return (torch.all(torch.isfinite(dv), dim=-1)
                & (torch.sum(dv < 0, dim=-1) == neq))

    def shifted(Hb, dlt, sd):
        Hm = Hb.clone()
        dg = Hm.diagonal(dim1=-2, dim2=-1)
        dg.copy_(dg + dlt[:, None] * sd)
        return Hm

    def put(facs, ids, sub):
        for f, g in zip(facs, sub):
            f[ids] = g

    facs = factor(Hs)
    dv0 = facs[1]
    ok0 = ldlt_inertia_ok(dv0, neq, eps_t)
    zero_b = H.new_zeros((Bn,))
    delta_new, delta_applied, eq_shift = delta, zero_b, zero_b
    retries = 0
    fix = _sync.indices(~ok0)                     # the skip of the retries
    if fix.numel():
        if neq:
            ad0 = torch.abs(dv0)
            rcond0 = (torch.amin(ad0, dim=-1)
                      / torch.clamp(torch.amax(ad0, dim=-1), min=tiny))
            illcond = ((~torch.all(torch.isfinite(dv0), dim=-1))
                       | (rcond0 <= eps_t))
            reg = _eq_reg_term(mu, reg_coef, eta, beta)
            eq_shift = torch.where((~ok0) & illcond, reg, zero_b)
        # the bad blocks only, with their warm-started entry shift
        Hb = Hs[fix]
        Hb.diagonal(dim1=-2, dim2=-1).sub_(eq_shift[fix, None]
                                           * eq_diag[fix])
        sd = shift_diag[fix]
        df = delta[fix]
        dlt = torch.where(df == 0, delta0_t, torch.clamp(df / 2, min=delta0))
        sub = factor(shifted(Hb, dlt, sd))
        put(facs, fix, sub)
        bad = ~shift_ok(sub[1])
        while retries < max_retries:
            loop = _sync.indices(bad)
            if loop.numel() == 0:
                break
            dlt[loop] = dlt[loop] * 10.0
            sub = factor(shifted(Hb[loop], dlt[loop], sd[loop]))
            put(facs, fix[loop], sub)
            bad[loop] = ~shift_ok(sub[1])
            retries += 1
        delta_new = delta.clone()
        delta_new[fix] = dlt
        delta_applied = zero_b.clone()
        delta_applied[fix] = dlt

    def solve_fn(Bc):
        with annotate("ipm-kkt-solve", dev):
            return dsc[..., None] * fsolve(facs, dsc[..., None] * Bc)

    return solve_fn, delta_new, retries, (delta_applied, eq_shift)


def lstsq_minnorm(A, b):
    """Minimum-norm least squares for (B, m, n), (B, m) -> (B, n), through
    lightly regularized normal equations with guarded refinement
    (JAX linalg.py:1372-1459)."""
    _, m, n = A.shape
    dtype = A.dtype
    reg = torch.sqrt(_scalar(torch.finfo(dtype).eps, A))

    def reg_solve(G, rhs, k):
        diag = torch.diagonal(G, dim1=-2, dim2=-1)
        scale = torch.clamp(torch.sum(diag, dim=-1) / k, min=1.0)
        eye = torch.eye(k, dtype=dtype, device=A.device)
        Greg = G + (reg * scale)[:, None, None] * eye
        if k > SMALL_K:
            # large normal matrices: LU, as the JAX package (:1397-1399)
            LU, piv = torch.linalg.lu_factor(Greg)

            def solve(r_):
                return torch.linalg.lu_solve(LU, piv, r_[..., None])[..., 0]
        else:
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
