"""Fraction-to-the-boundary step and the merit line search, batch first
(counterpart of ``pyipm_tpu/core/linesearch.py``).

The JAX package runs the accept / second-order-correct / backtrack / abort
policy per instance under ``lax.cond``; here each branch is computed only
for the instances that take it (gathered subsets), and the result of every
instance is the one its own JAX search computes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pyipm_tpu_torch import _sync
from pyipm_tpu_torch.core import kkt as K
from pyipm_tpu_torch.core.problem import Problem
from pyipm_tpu_torch.ops.linalg import lstsq_minnorm
from pyipm_tpu_torch.utils import profiling


def take(p, ids):
    """Rows ``ids`` of every tensor of a (Named)tuple of batched tensors."""
    rows = tuple(t[ids] for t in p)
    return type(p)(*rows) if hasattr(p, "_fields") else rows


def max_step_ftb(z, dz, tau):
    """Largest alpha in [0, 1] with z + alpha*dz >= (1-tau)*z, per row of
    (B, n) (closed form of pyipm.py:1408-1436)."""
    if z.shape[-1] == 0:
        return z.new_ones(z.shape[:-1])
    tau_ = torch.as_tensor(tau, dtype=z.dtype, device=z.device)
    neg = dz < 0
    denom = torch.where(neg, -dz, torch.ones_like(dz))
    ratio = torch.where(neg, tau_ * z / denom,
                        torch.full_like(z, float("inf")))
    return torch.clamp(torch.amin(ratio, dim=-1), max=1.0)


def backtrack_armijo(phi_at, armijo_rhs, base, a_s_in, a_l_in, *, tau, eps,
                     chunk, max_backtrack):
    """Chunked Armijo backtracking on a_k = a_in * tau^(k+1)
    (JAX linesearch.py:53-117), for a batch of b instances.

    ``phi_at(ids, a)`` and ``armijo_rhs(ids, a)`` evaluate instances
    ``ids`` at trial step lengths a (len(ids), W).  Each loop step tests one
    chunk of W trials for the instances not yet done and takes the FIRST
    event (pass, or the step shrinking below eps) of the chunk.
    Returns (a_s, a_l, aborted), each (b,)."""
    b = a_s_in.shape[0]
    dtype, dev = a_s_in.dtype, a_s_in.device
    tau_t = torch.as_tensor(tau, dtype=dtype, device=dev)
    W = int(chunk)
    ks0 = torch.arange(W, dtype=torch.int32, device=dev)
    found = torch.zeros((b,), dtype=torch.bool, device=dev)
    passed = torch.zeros_like(found)
    a_s = a_s_in * tau_t
    a_l = a_l_in * tau_t
    active = torch.ones_like(found)
    c = 0
    while c * W < max_backtrack:
        ids = _sync.indices(active)
        if ids.numel() == 0:
            break
        shrink = torch.pow(tau_t, (c * W + ks0 + 1).to(dtype))     # (W,)
        a_s_k = a_s_in[ids, None] * shrink
        a_l_k = a_l_in[ids, None] * shrink
        passes = phi_at(ids, a_s_k) <= armijo_rhs(ids, a_s_k)
        abort_k = shrink * base[ids, None] < eps
        events = passes | abort_k
        first = torch.argmax(events.to(torch.int8), dim=1, keepdim=True)
        hit = torch.any(events, dim=1)
        found[ids] = hit
        passed[ids] = torch.gather(passes, 1, first).squeeze(1)
        a_s[ids] = torch.gather(a_s_k, 1, first).squeeze(1)
        a_l[ids] = torch.gather(a_l_k, 1, first).squeeze(1)
        active = torch.zeros_like(active)
        active[ids] = ~hit
        c += 1
    return a_s, a_l, found & ~passed


def merit_line_search(phi_at, armijo_rhs, base_of, a_s_max, a_l_max,
                      try_soc, payload_zero, *, tau, eps, chunk,
                      max_backtrack):
    """The accept / second-order-correct / backtrack / abort policy of the
    merit line search (reference pyipm.py:1462-1551; JAX
    linesearch.py:120-168), batch first and generic over the problem.

    Args:
      phi_at(ids, a), armijo_rhs(ids, a): merit and acceptance threshold of
        instances ``ids`` at primal step lengths a, (n,) or (n, W).
      base_of(ids): step norms at the entry step lengths (abort test).
      a_s_max / a_l_max: (b,) fraction-to-the-boundary step lengths.
      try_soc(ids) -> (accepted (n,), payload): the second-order
        correction at a_s_max for instances ``ids``, or None when the
        problem has no constraints.
      payload_zero: (b, ...) tensors, the payload of every instance that
        takes no correction.

    Returns (a_s, a_l, soc, aborted, payload), each with a leading b axis.
    Each branch runs only on the instances that take it."""
    b = a_s_max.shape[0]
    everyone = torch.arange(b, device=a_s_max.device)
    pass0 = phi_at(everyone, a_s_max) <= armijo_rhs(everyone, a_s_max)
    a_s = a_s_max.clone()
    a_l = a_l_max.clone()
    soc = torch.zeros_like(pass0)
    aborted = torch.zeros_like(pass0)
    payload = tuple(t.clone() for t in payload_zero)

    if try_soc is not None:
        f_ids = _sync.indices(~pass0)
        if f_ids.numel():
            accepted, pay = try_soc(f_ids)
            soc[f_ids] = accepted
            for t, u in zip(payload, pay):
                keep = accepted.view(accepted.shape + (1,) * (u.dim() - 1))
                t[f_ids] = torch.where(keep, u, t[f_ids])

    bt_ids = _sync.indices(~pass0 & ~soc)
    if bt_ids.numel():
        a_s_b, a_l_b, ab = backtrack_armijo(
            lambda i, a: phi_at(bt_ids[i], a),
            lambda i, a: armijo_rhs(bt_ids[i], a),
            base_of(bt_ids), a_s_max[bt_ids], a_l_max[bt_ids], tau=tau,
            eps=eps, chunk=chunk, max_backtrack=max_backtrack)
        a_s[bt_ids] = a_s_b
        a_l[bt_ids] = a_l_b
        aborted[bt_ids] = ab
    return a_s, a_l, soc, aborted, payload


class SearchResult(NamedTuple):
    x: torch.Tensor
    s: torch.Tensor
    lda: torch.Tensor
    signal: torch.Tensor     # -2 on unreliable direction, else unchanged
    alpha: torch.Tensor      # accepted primal step length
    soc: torch.Tensor        # bool: second-order correction accepted


def search(problem: Problem, cfg, x0, s0, lda0, dz, alpha_smax, alpha_lmax,
           mu, nu, signal, p):
    """Backtracking merit line search with second-order correction
    (reference IPM.search, pyipm.py:1438-1565; JAX linesearch.py:180-288).
    On abort the iterates come back unchanged with signal -2."""
    D, N = problem.nvar, problem.nineq
    b = x0.shape[0]
    eta = torch.as_tensor(cfg.eta, dtype=x0.dtype, device=x0.device)
    tau = cfg.tau

    dx = dz[:, :D]
    ds = dz[:, D:D + N]
    dl = dz[:, D + N:]

    phi0 = K.phi(problem, x0, s0, mu, nu, p)
    dphi0 = K.dphi(problem, x0, s0, dz[:, :D + N], mu, nu, p)
    # roundoff-aware Armijo slack (JAX linesearch.py:201-207)
    slack = 10.0 * cfg.eps * (1.0 + torch.abs(phi0))

    def armijo_rhs(ids, a):
        ext = (slice(None),) + (None,) * (a.dim() - 1)
        return (phi0[ids][ext] + a * eta * dphi0[ids][ext]
                + slack[ids][ext])

    def phi_at(ids, a):
        """Merit at x0 + a*dx for instances ``ids``; a is (n,) or (n, W)."""
        pi = take(p, ids)
        if a.dim() == 1:
            return K.phi(problem, x0[ids] + a[:, None] * dx[ids],
                         s0[ids] + a[:, None] * ds[ids], mu[ids], nu[ids], pi)
        return K.phi(problem,
                     x0[ids][:, None] + a[..., None] * dx[ids][:, None],
                     s0[ids][:, None] + a[..., None] * ds[ids][:, None],
                     mu[ids], nu[ids], pi)

    def base_of(ids):
        base = torch.linalg.vector_norm(alpha_smax[ids, None] * dx[ids],
                                        dim=-1)
        if N:
            base = torch.sqrt(base ** 2 + torch.linalg.vector_norm(
                alpha_lmax[ids, None] * ds[ids], dim=-1) ** 2)
        return base

    def try_soc(ids):
        """Second-order feasibility correction at a_s_max, applied where
        infeasibility went up (pyipm.py:1464-1489, 1516-1536), in the
        profiling scope ``ipm-soc``.  Returns (accepted, (dz_p, a_corr))
        for instances ``ids``."""
        with profiling.annotate("ipm-soc", x0.device):
            n = ids.numel()
            accepted = torch.zeros((n,), dtype=torch.bool, device=x0.device)
            dz_p = x0.new_zeros((n, D + N))
            a_corr = x0.new_ones((n,))
            pf = take(p, ids)
            am = alpha_smax[ids, None]
            xa = x0[ids] + am * dx[ids]
            sa = s0[ids] + am * ds[ids]
            c_old = K.con(problem, x0[ids], s0[ids], pf)
            c_new = K.con(problem, xa, sa, pf)
            up = (torch.sum(torch.abs(c_new), dim=-1)
                  > torch.sum(torch.abs(c_old), dim=-1))
            loc = _sync.indices(up)
            if loc.numel() == 0:
                return accepted, (dz_p, a_corr)
            g = ids[loc]
            pg = take(p, g)
            A = K.jaco(problem, x0[g], pg).transpose(1, 2)       # (M+N, D+N)
            dzp = -lstsq_minnorm(A, c_new[loc])
            rhs = armijo_rhs(g, alpha_smax[g])
            ok = K.phi(problem, xa[loc] + dzp[:, :D], sa[loc] + dzp[:, D:],
                       mu[g], nu[g], pg) <= rhs
            if N:
                step_x = alpha_smax[g, None] * dx[g] + dzp[:, :D]
                step_s = alpha_smax[g, None] * ds[g] + dzp[:, D:]
                ac = max_step_ftb(s0[g], step_s, tau)
                ok = ok & (K.phi(problem, x0[g] + ac[:, None] * step_x,
                                 s0[g] + ac[:, None] * step_s, mu[g], nu[g],
                                 pg) <= rhs)
                a_corr[loc] = ac
            accepted[loc] = ok
            dz_p[loc] = dzp
            return accepted, (dz_p, a_corr)

    a_s, a_l, soc, aborted, (dz_p, a_corr) = merit_line_search(
        phi_at, armijo_rhs, base_of, alpha_smax, alpha_lmax,
        try_soc if problem.ncon else None,
        (x0.new_zeros((b, D + N)), x0.new_ones((b,))),
        tau=tau, eps=cfg.eps, chunk=cfg.backtrack_chunk,
        max_backtrack=cfg.max_backtrack)

    # accepted state (JAX linesearch.py:267-278); abort keeps the iterate
    one = torch.ones_like(a_s)
    corr = torch.where(soc, a_corr, one)[:, None]
    gate = torch.where(soc, one, torch.zeros_like(one))[:, None]
    x = x0 + corr * (a_s[:, None] * dx + gate * dz_p[:, :D])
    s = s0 + corr * (a_s[:, None] * ds + gate * dz_p[:, D:])
    lda = lda0 + a_l[:, None] * dl if problem.ncon else lda0
    ab = aborted[:, None]
    return SearchResult(
        x=torch.where(ab, x0, x), s=torch.where(ab, s0, s),
        lda=torch.where(ab, lda0, lda),
        signal=torch.where(aborted, torch.full_like(signal, -2), signal),
        alpha=torch.where(aborted, torch.zeros_like(a_s), a_s),
        soc=soc & ~aborted)
