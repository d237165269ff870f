"""The interior-point solver, batch first (counterpart of
``pyipm_tpu/core/solver.py``).

The JAX solver is a per-instance ``lax.while_loop`` over a flat outer/inner
state machine (``make_loop_engine``, solver.py:116-264), vmapped over a
fleet.  PyTorch cannot map a loop whose exit depends on the data, so here
the :class:`SolverState` carries a leading instance axis — loop position
(outer, inner, inner_done, in_inner, signal) included — and ONE host loop
advances every still-running instance by one flat step at a time:

  - an instance at the top of an outer iteration takes the convergence
    check (``outer_start``);
  - an instance inside an inner loop takes one inner step, and the outer
    epilogue when that step ends its inner loop.

Each ``lax.cond`` becomes a masked ``torch.where`` merge, and the costly
branch (one primal-dual iteration) runs on the gathered subset of
instances that take it.  Per instance the result is that of a single JAX
solve; a single solve is a batch of one.

Signals: 0 running | 1 Ktol converged | 2 Ftol converged | -1 max
iterations | -2 unreliable search direction | -3 non-finite iterate.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pyipm_tpu_torch import _sync
from pyipm_tpu_torch.config import IPMConfig, matmul_precision
from pyipm_tpu_torch.core import kkt as K
from pyipm_tpu_torch.core.linesearch import max_step_ftb, search, take
from pyipm_tpu_torch.core.problem import Problem
from pyipm_tpu_torch.core.updates import centrality_mu, nu_threshold
from pyipm_tpu_torch.ops.condensed import condensed_direction
from pyipm_tpu_torch.ops.linalg import reg_solve_kkt


class SolverState(NamedTuple):
    """Batch-first solver state; every field has a leading instance axis.
    Everything a paused solve needs to resume is here (the JAX package's
    ``run_budget`` reads ``iter_count``)."""
    x: torch.Tensor            # (B, D)
    s: torch.Tensor            # (B, N)
    lda: torch.Tensor          # (B, M+N)
    mu: torch.Tensor           # (B,)
    nu: torch.Tensor
    delta: torch.Tensor        # inertia-correction shift, warm-started
    kkt: torch.Tensor          # (B, 4) KKT condition norms
    signal: torch.Tensor       # int32
    iter_count: torch.Tensor   # int32 total inner iterations
    outer: torch.Tensor        # int32 outer iteration index
    inner: torch.Tensor        # int32 inner index within the outer
    inner_done: torch.Tensor   # bool: inner loop hit its muTol exit
    in_inner: torch.Tensor     # bool: mid inner loop
    f_past: torch.Tensor       # last cost for the Ftol test
    alpha: torch.Tensor        # last accepted primal step length
    reg_retries: torch.Tensor  # int32 cumulative inertia-correction retries


class SolverResult(NamedTuple):
    x: torch.Tensor
    s: torch.Tensor
    lda: torch.Tensor
    fval: torch.Tensor
    kkt: torch.Tensor
    signal: torch.Tensor
    iter_count: torch.Tensor
    outer: torch.Tensor
    inner: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor
    delta: torch.Tensor
    reg_retries: torch.Tensor


def _where(mask, new, old):
    return torch.where(mask.view(mask.shape + (1,) * (old.dim() - 1)),
                       new, old)


def _merge(st: SolverState, mask, **fields) -> SolverState:
    """Take ``fields`` where ``mask`` is set, keep ``st`` elsewhere."""
    return st._replace(**{k: _where(mask, v, getattr(st, k))
                          for k, v in fields.items()})


def _put(st: SolverState, ids, sub: SolverState) -> SolverState:
    return SolverState(*(t.index_copy(0, ids, u) for t, u in zip(st, sub)))


def _check_supported(cfg: IPMConfig, nineq: int) -> IPMConfig:
    cfg = cfg.resolve_mu_strategy(nineq)
    if cfg.lbfgs:
        raise NotImplementedError(
            "lbfgs > 0: the L-BFGS direction is ROADMAP Slice C (item 14), "
            "not ported yet")
    if cfg.mu_strategy == "mehrotra":
        raise NotImplementedError(
            "mu_strategy resolving to 'mehrotra': the predictor-corrector "
            "direction is deferred (ROADMAP Slice A item 5, "
            "condensed_direction_mehrotra)")
    if cfg.linear_solver == "lu":
        raise NotImplementedError(
            "linear_solver='lu': the eigendecomposition parity path "
            "(_reg_solve_eigh) is not ported yet; use 'condensed' or "
            "'ldlt'")
    if cfg.trace_metrics:
        raise NotImplementedError(
            "trace_metrics: per-iteration histories are ROADMAP Slice C "
            "(item 16, observability), not ported yet")
    return cfg


class BatchSolver:
    """Batch-first solver for one :class:`Problem` and configuration.

    ``solver(x0, params=(), s0=None, lda0=None) -> SolverResult`` solves
    the (B, D) batch ``x0``; ``params`` holds the per-instance data the
    problem's callables read, each with a leading B axis.  Flat steps and
    host syncs are counted in ``pyipm_tpu_torch._sync.COUNTS``."""

    def __init__(self, problem: Problem, config: Optional[IPMConfig] = None):
        cfg = config if config is not None else IPMConfig()
        self.problem = problem
        self.config = _check_supported(cfg, problem.nineq)

    # ------------------------------------------------------------------
    def direction(self, st: SolverState, p):
        """Newton direction and the new delta (reference pyipm.py:
        1717-1721): the slack-eliminated condensed system by default, the
        full (D+2N+M)^2 KKT matrix with ``linear_solver='ldlt'`` (JAX
        solver.py:318-329).  Returns (dz, delta_new, retries)."""
        problem, cfg = self.problem, self.config
        if cfg.linear_solver == "condensed":
            return condensed_direction(problem, cfg, st.x, st.s, st.lda,
                                       st.mu, st.delta, p)
        g = -K.grad(problem, st.x, st.s, st.lda, st.mu, p)
        H = K.kkt_matrix(problem, st.x, st.s, st.lda, st.mu, p)
        return reg_solve_kkt(
            H, g, st.delta, st.mu, nvar=problem.nvar, neq=problem.neq,
            nineq=problem.nineq, eps=cfg.eps, reg_coef=cfg.reg_coef,
            eta=cfg.eta, beta=cfg.beta, delta0=cfg.delta0,
            max_retries=cfg.max_reg_retries, block=cfg.ldlt_block)

    def inner_iter(self, st: SolverState, p) -> SolverState:
        """One primal-dual iteration for every instance of ``st`` (the
        body of the reference's inner loop, pyipm.py:1672-1770)."""
        problem, cfg = self.problem, self.config
        D, M, N = problem.nvar, problem.neq, problem.nineq
        dtype = st.x.dtype
        tiny = torch.finfo(dtype).tiny

        dz, delta_new, retries = self.direction(st, p)
        st = st._replace(delta=delta_new,
                         reg_retries=st.reg_retries + retries)

        if problem.ncon:
            # multiplier sign flip (pyipm.py:1723-1725) and merit penalty
            # update (pyipm.py:1727-1735)
            dz = torch.cat([dz[:, :D + N], -dz[:, D + N:]], dim=-1)
            bdot = torch.sum(K.barrier_cost_grad(problem, st.x, st.s, st.mu, p)
                             * dz[:, :D + N], dim=-1)
            cl1 = torch.sum(torch.abs(K.con(problem, st.x, st.s, p)), dim=-1)
            st = st._replace(nu=torch.maximum(
                st.nu, nu_threshold(bdot, cl1, cfg.rho, tiny)))

        if N:
            # fraction-to-the-boundary (pyipm.py:1737-1742)
            a_s = max_step_ftb(st.s, dz[:, D:D + N], cfg.tau)
            a_l = max_step_ftb(st.lda[:, M:], dz[:, D + N + M:], cfg.tau)
        else:
            a_s = st.x.new_ones(st.x.shape[:1])
            a_l = st.x.new_ones(st.x.shape[:1])

        if cfg.inject_solve_fault:
            dz = dz + cfg.inject_solve_fault * torch.roll(dz, 1, dims=-1)

        res = search(problem, cfg, st.x, st.s, st.lda, dz, a_s, a_l,
                     st.mu, st.nu, st.signal, p)
        st = st._replace(x=res.x, s=res.s, lda=res.lda, signal=res.signal,
                         alpha=res.alpha, iter_count=st.iter_count + 1)
        st = st._replace(kkt=K.kkt_norms(problem, st.x, st.s, st.lda,
                                         st.mu, p))

        if cfg.nan_guard:
            finite = (torch.all(torch.isfinite(st.x), dim=-1)
                      & torch.all(torch.isfinite(st.s), dim=-1)
                      & torch.all(torch.isfinite(st.lda), dim=-1)
                      & torch.all(torch.isfinite(st.kkt), dim=-1))
            st = st._replace(signal=torch.where(
                (st.signal >= 0) & ~finite,
                torch.full_like(st.signal, -3), st.signal))

        if cfg.Ftol is not None and N == 0:
            # per-iteration Ftol test, unconstrained/eq-only
            # (pyipm.py:1756-1766)
            f_new = problem.f_val(st.x, p)
            live = st.signal != -2
            hit = live & (torch.abs(st.f_past - f_new) <= abs(cfg.Ftol))
            st = st._replace(
                signal=torch.where(hit, torch.full_like(st.signal, 2),
                                   st.signal),
                f_past=torch.where(live, f_new, st.f_past))
        return st

    def outer_epilogue(self, st: SolverState, ep, p) -> SolverState:
        """What follows an inner loop (pyipm.py:1776-1814), where ``ep``."""
        problem, cfg = self.problem, self.config
        M, N = problem.neq, problem.nineq
        if cfg.Ftol is not None and N:
            chk = ep & (st.signal != -2)
            f_new = problem.f_val(st.x, p)
            hit = chk & (torch.abs(st.f_past - f_new) <= abs(cfg.Ftol))
            st = st._replace(
                signal=torch.where(hit, torch.full_like(st.signal, 2),
                                   st.signal),
                f_past=torch.where(chk, f_new, st.f_past))
        is_last = st.outer >= cfg.niter - 1
        st = st._replace(signal=torch.where(
            ep & (st.signal == 0) & is_last,
            torch.full_like(st.signal, -1), st.signal))
        if N:
            # adaptive centrality barrier update (pyipm.py:1804-1814)
            sli = st.s * st.lda[:, M:]
            mu_new = centrality_mu(torch.sum(sli, dim=-1),
                                   torch.amin(sli, dim=-1), N, cfg.eps,
                                   cfg.mu_floor)
            st = _merge(st, ep & (st.signal == 0), mu=mu_new)
        return _merge(st, ep, outer=st.outer + 1,
                      in_inner=torch.zeros_like(st.in_inner))

    def flat_step(self, st: SolverState, running, p) -> SolverState:
        """Advance every running instance by one phase step."""
        problem, cfg = self.problem, self.config
        Ktol = cfg.Ktol
        mo = running & ~st.in_inner
        mi = running & st.in_inner

        # top-of-outer convergence check (pyipm.py:1663-1667)
        conv = torch.all(st.kkt <= Ktol, dim=-1)
        hit = mo & conv
        enter = mo & ~conv
        st = _merge(st, hit, signal=torch.ones_like(st.signal),
                    outer=st.outer + 1)
        st = _merge(st, enter, inner=torch.zeros_like(st.inner),
                    inner_done=torch.zeros_like(st.inner_done),
                    in_inner=torch.ones_like(st.in_inner))

        # one inner step (pyipm.py:1672-1682): muTol exit or an iteration
        active = (mi & (st.inner < cfg.miter) & (st.signal == 0)
                  & ~st.inner_done)
        mutol = torch.clamp(st.mu, min=Ktol)
        conv_in = torch.all(st.kkt <= mutol[:, None], dim=-1)
        stop = active & conv_in
        if problem.ncon == 0:
            st = _merge(st, stop, signal=torch.ones_like(st.signal))
        st = _merge(st, stop, inner_done=torch.ones_like(st.inner_done))
        ids = _sync.indices(active & ~conv_in)
        if ids.numel():
            sub = SolverState(*(t[ids] for t in st))
            sub = self.inner_iter(sub, take(p, ids))
            st = _put(st, ids, sub._replace(inner=sub.inner + 1))

        done = mi & ((st.inner >= cfg.miter) | (st.signal != 0)
                     | st.inner_done)
        return self.outer_epilogue(st, done, p)

    def run(self, st: SolverState, p) -> SolverState:
        while True:
            running = (st.outer < self.config.niter) & (st.signal == 0)
            if not _sync.any_true(running):
                return st
            st = self.flat_step(st, running, p)
            _sync.COUNTS["flat_steps"] += 1

    # ------------------------------------------------------------------
    def init_state(self, x0, p=(), s0=None, lda0=None) -> SolverState:
        """Initialization (reference pyipm.py:1596-1651)."""
        problem, cfg = self.problem, self.config
        D, M, N = problem.nvar, problem.neq, problem.nineq
        dtype = cfg.torch_dtype
        x = x0.to(dtype).reshape(-1, D)
        B = x.shape[0]
        full = lambda v: x.new_full((B,), v)      # noqa: E731
        if N:
            s = (K.init_slack(problem, x, cfg.Ktol, p) if s0 is None
                 else s0.to(dtype).reshape(B, N))
            mu0 = full(cfg.mu)
        else:
            s = x.new_zeros((B, 0))
            mu0 = full(cfg.Ktol)
        if M + N:
            lda = (K.init_lambda(problem, x, cfg.Ktol, p) if lda0 is None
                   else lda0.to(dtype).reshape(B, M + N))
        else:
            lda = x.new_zeros((B, 0))
        kkt0 = K.kkt_norms(problem, x, s, lda, mu0, p)
        f_past = (problem.f_val(x, p) if cfg.Ftol is not None
                  else x.new_zeros((B,)))
        def i32():
            return torch.zeros((B,), dtype=torch.int32, device=x.device)

        def no():
            return torch.zeros((B,), dtype=torch.bool, device=x.device)

        return SolverState(
            x=x, s=s, lda=lda, mu=mu0, nu=full(cfg.nu), delta=full(0.0),
            kkt=kkt0, signal=i32(), iter_count=i32(), outer=i32(),
            inner=i32(), inner_done=no(), in_inner=no(), f_past=f_past,
            alpha=full(0.0), reg_retries=i32())

    def finalize(self, st: SolverState, p=()) -> SolverResult:
        return SolverResult(
            x=st.x, s=st.s, lda=st.lda, fval=self.problem.f_val(st.x, p),
            kkt=st.kkt, signal=st.signal, iter_count=st.iter_count,
            outer=st.outer, inner=st.inner, mu=st.mu, nu=st.nu,
            delta=st.delta, reg_retries=st.reg_retries)

    def __call__(self, x0, params=(), s0=None, lda0=None) -> SolverResult:
        with torch.no_grad(), matmul_precision(self.config.matmul_precision):
            st = self.init_state(x0, params, s0, lda0)
            return self.finalize(self.run(st, params), params)


def make_solver(problem: Problem,
                config: Optional[IPMConfig] = None) -> BatchSolver:
    """Build the batch-first solver for (problem, config)."""
    return BatchSolver(problem, config)


def solve(problem: Problem, x0, config: Optional[IPMConfig] = None,
          s0=None, lda0=None, params=()) -> SolverResult:
    """Solve ONE instance: ``x0`` (D,), ``params`` that instance's data.
    Runs as a batch of one and returns unbatched fields."""
    p1 = tuple(t.unsqueeze(0) for t in params)
    if hasattr(params, "_fields"):
        p1 = type(params)(*p1)
    res = make_solver(problem, config)(
        x0.reshape(1, -1), p1,
        None if s0 is None else s0.reshape(1, -1),
        None if lda0 is None else lda0.reshape(1, -1))
    return SolverResult(*(t[0] for t in res))
