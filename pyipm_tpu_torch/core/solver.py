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
solve; a single solve is a batch of one, and only it prints the JAX
solver's progress lines (``verbosity > 0``), at the cost of a host sync per
line; a fleet prints nothing.

Every piece of loop position lives in the state, so :meth:`LoopEngine.
run_budget` can pause a solve after a number of inner iterations per
instance and :meth:`LoopEngine.run` resume it exactly: the mechanism of
the wave-compacted fleet (``parallel/batch.py``) and of checkpoints
(``utils/checkpoint.py``).

The loop itself is :class:`LoopEngine` (the JAX package's
``make_loop_engine``, solver.py:116-264): the muTol inner exits, the Ftol
placement, the signal taxonomy, the mu schedule, pause and resume and the
``trace_metrics`` rows live there once.  :class:`BatchSolver` (a fleet)
and the block-separable Schur solver (``parallel/schur.py``, one instance
whose loop fields are a batch of one) each supply the iteration body, the
objective and the centrality statistics.  ``trace_metrics`` keeps per-iteration
histories (:class:`MetricsHistory`), and the phases carry the profiling
scopes of ``utils/profiling.py``.

Signals: 0 running | 1 Ktol converged | 2 Ftol converged | -1 max
iterations | -2 unreliable search direction | -3 non-finite iterate.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from pyipm_tpu_torch import _sync
from pyipm_tpu_torch.config import IPMConfig, matmul_precision
from pyipm_tpu_torch.core import kkt as K
from pyipm_tpu_torch.core.lbfgs import (
    LBFGSState, lbfgs_direction, lbfgs_init, lbfgs_update,
)
from pyipm_tpu_torch.core.linesearch import max_step_ftb, search, take
from pyipm_tpu_torch.core.problem import Problem
from pyipm_tpu_torch.core.updates import centrality_mu, nu_threshold
from pyipm_tpu_torch.ops.condensed import (
    condensed_direction, condensed_direction_mehrotra,
)
from pyipm_tpu_torch.ops.linalg import reg_solve_kkt
from pyipm_tpu_torch.utils import profiling


class MetricsHistory(NamedTuple):
    """Per-iteration traces of a ``trace_metrics=True`` solve, indexed by
    ``iter_count - 1``; T = niter * miter, and T = 0 when tracing is off."""
    kkt: torch.Tensor          # (B, T, 4)
    mu: torch.Tensor           # (B, T)
    nu: torch.Tensor
    alpha: torch.Tensor
    delta: torch.Tensor


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
    # L-BFGS only (None in exact-Hessian mode, so the fleet carries none)
    lbfgs: Optional[LBFGSState] = None
    x_old: Optional[torch.Tensor] = None   # (B, D) previous iterate
    g: Optional[torch.Tensor] = None       # (B, K) cached -grad
    # trace_metrics only (None otherwise)
    hist: Optional[MetricsHistory] = None


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
    hist: MetricsHistory       # (B, 0, ...) fields when tracing is off


def _where(mask, new, old):
    return torch.where(mask.view(mask.shape + (1,) * (old.dim() - 1)),
                       new, old)


def _merge(st: SolverState, mask, **fields) -> SolverState:
    """Take ``fields`` where ``mask`` is set, keep ``st`` elsewhere."""
    return st._replace(**{k: _where(mask, v, getattr(st, k))
                          for k, v in fields.items()})


def _tree(fn, *trees):
    """``fn`` over the tensors of (nested) NamedTuples; None stays None."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        return type(first)(*(_tree(fn, *parts) for parts in zip(*trees)))
    return fn(*trees)


def _rows(st: SolverState, ids) -> SolverState:
    return _tree(lambda t: t[ids], st)


def _put(st: SolverState, ids, sub: SolverState) -> SolverState:
    return _tree(lambda t, u: t.index_copy(0, ids, u), st, sub)


def _phase(name: str):
    """Run a solver phase without autograd, at the configured matmul
    precision (the JAX package's ``_prec``, solver.py:548-560), so that a
    budgeted or resumed run computes what a straight solve does, in the
    profiling scope ``name`` on the solver's device, or where the solver
    has none, the device of its first argument (a state, or the start
    x0)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(self, first, *a, **kw):
            dev = getattr(self, "device", None)
            if dev is None:
                dev = getattr(getattr(first, "x", first), "device", None)
            with torch.no_grad(), \
                    matmul_precision(self.config.matmul_precision), \
                    profiling.annotate(name, dev):
                return fn(self, first, *a, **kw)
        return wrapped
    return deco


def _empty_history(x, T: int) -> MetricsHistory:
    """Zeroed (B, T, ...) history buffers in x's dtype and device."""
    B = x.shape[0]
    return MetricsHistory(x.new_zeros((B, T, 4)),
                          *(x.new_zeros((B, T)) for _ in range(4)))


def _record(hist: MetricsHistory, ids, t, row: MetricsHistory):
    """Write row ``t`` (the stepped instances' ``iter_count - 1``) of each
    stepped instance ``ids`` (in place: :meth:`LoopEngine._loop` owns the
    buffers it writes)."""
    for k in MetricsHistory._fields:
        getattr(hist, k).index_put_((ids, t), getattr(row, k))


def _leaves(t):
    """The tensors of a tensor or (nested) tuple of tensors."""
    if isinstance(t, tuple):
        return [u for v in t for u in _leaves(v)]
    return [t]


def _check_finite(sub: SolverState):
    """``enable_nan_debugging``: raise at the first non-finite field, with
    one host sync a step (the field is named on the failure path only)."""
    fields = ("x", "s", "lda", "kkt")
    bad = torch.stack([torch.stack([~torch.isfinite(t).all()
                                    for t in _leaves(getattr(sub, k))]).any()
                       for k in fields])
    if _sync.any_true(bad):
        k = fields[int(bad.int().argmax())]
        raise FloatingPointError(f"non-finite {k} after an inner iteration "
                                 f"(enable_nan_debugging)")


class LoopEngine:
    """The flattened outer/inner interior-point loop over a batch-first
    :class:`SolverState` (JAX ``make_loop_engine``, solver.py:116-264),
    generic over the iteration body.

    Subclasses set ``config`` (a resolved :class:`IPMConfig`), ``echo``,
    ``has_ineq`` (the Ftol placement and the barrier schedule),
    ``unconstrained`` (the muTol exit is then convergence) and
    ``lazy_epilogue`` (a host sync skips an outer epilogue no instance
    takes: for a solver whose epilogue pays collectives), and define:

      - ``inner_iter(st, p)``: one primal-dual iteration of every instance
        of ``st``, ``iter_count`` bumped;
      - ``f_val(st, p)``: the (B,) objective, for the Ftol test;
      - ``centrality_stats(st, p)``: (sum s.li, min s*li, pair count);
      - ``take(st, ids, p)`` -> (sub-state, its data) and
        ``put(st, ids, sub)``: gather and scatter the instances ``ids``;
      - ``history_row(sub)``: the :class:`MetricsHistory` row of stepped
        instances."""

    lazy_epilogue = False

    def outer_epilogue(self, st: SolverState, ep, p) -> SolverState:
        """What follows an inner loop (pyipm.py:1776-1814), where ``ep``."""
        cfg = self.config
        if cfg.Ftol is not None and self.has_ineq:
            chk = ep & (st.signal != -2)
            f_new = self.f_val(st, p)
            hit = chk & (torch.abs(st.f_past - f_new) <= abs(cfg.Ftol))
            st = st._replace(
                signal=torch.where(hit, torch.full_like(st.signal, 2),
                                   st.signal),
                f_past=torch.where(chk, f_new, st.f_past))
        is_last = st.outer >= cfg.niter - 1
        st = st._replace(signal=torch.where(
            ep & (st.signal == 0) & is_last,
            torch.full_like(st.signal, -1), st.signal))
        if self.has_ineq and cfg.mu_strategy != "mehrotra":
            # adaptive centrality barrier update (pyipm.py:1804-1814); under
            # 'mehrotra' mu moves every iteration inside the direction
            sl, smin, ntot = self.centrality_stats(st, p)
            mu_new = centrality_mu(sl, smin, ntot, cfg.eps, cfg.mu_floor)
            st = _merge(st, ep & (st.signal == 0), mu=mu_new)
        return _merge(st, ep, outer=st.outer + 1,
                      in_inner=torch.zeros_like(st.in_inner))

    def flat_step(self, st: SolverState, running, p) -> SolverState:
        """Advance every running instance by one phase step."""
        cfg = self.config
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
        if self.echo and self.has_ineq and bool(enter[0]):
            print(f"OUTER ITERATION {int(st.outer[0]) + 1}")

        # one inner step (pyipm.py:1672-1682): muTol exit or an iteration
        active = (mi & (st.inner < cfg.miter) & (st.signal == 0)
                  & ~st.inner_done)
        mutol = torch.clamp(st.mu, min=Ktol)
        conv_in = torch.all(st.kkt <= mutol[:, None], dim=-1)
        stop = active & conv_in
        if self.unconstrained:
            st = _merge(st, stop, signal=torch.ones_like(st.signal))
        st = _merge(st, stop, inner_done=torch.ones_like(st.inner_done))
        ids = _sync.indices(active & ~conv_in)
        if ids.numel():
            # the history is not gathered: each stepped row is written once
            hist, st = st.hist, st._replace(hist=None)
            sub = self.inner_iter(*self.take(st, ids, p))
            if profiling.nan_debugging():
                _check_finite(sub)
            st = self.put(st, ids, sub._replace(inner=sub.inner + 1))
            if hist is not None:
                _record(hist, ids, sub.iter_count.long() - 1,
                        self.history_row(sub))
            st = st._replace(hist=hist)

        done = mi & ((st.inner >= cfg.miter) | (st.signal != 0)
                     | st.inner_done)
        if self.lazy_epilogue and not _sync.any_true(done):
            return st
        with profiling.annotate("ipm-outer-epilogue", st.x.device):
            return self.outer_epilogue(st, done, p)

    @_phase("ipm-loop")
    def _loop(self, st: SolverState, p, limit=None) -> SolverState:
        """Flat steps until no instance runs; with ``limit`` (B,) an
        instance also stops once its ``iter_count`` reaches it."""
        if st.hist is not None:
            # the steps write rows in place: into a copy of the caller's
            st = st._replace(hist=_tree(torch.clone, st.hist))
        while True:
            running = (st.outer < self.config.niter) & (st.signal == 0)
            if limit is not None:
                running = running & (st.iter_count < limit)
            if not _sync.any_true(running):
                return st
            st = self.flat_step(st, running, p)
            _sync.COUNTS["flat_steps"] += 1

    def run(self, st: SolverState, p=()) -> SolverState:
        """Run every instance to the end of its solve."""
        return self._loop(st, p)

    def run_budget(self, st: SolverState, max_new_iters,
                   p=()) -> SolverState:
        """Advance each instance by at most ``max_new_iters`` more inner
        iterations (its own ``iter_count`` plus the budget, JAX
        solver.py:246-262), then pause.  ``signal == 0`` means paused; the
        state resumes exactly under :meth:`run` or :meth:`run_budget`."""
        return self._loop(st, p, limit=st.iter_count + int(max_new_iters))


class BatchSolver(LoopEngine):
    """Batch-first solver for one :class:`Problem` and configuration.

    ``solver(x0, params=(), s0=None, lda0=None, mu0=None, nu0=None) ->
    SolverResult`` solves the (B, D) batch ``x0``; ``params`` holds the
    per-instance data the problem's callables read, each with a leading B
    axis (see :meth:`init_state` for the warm starts).  Flat steps and
    host syncs are counted in ``pyipm_tpu_torch._sync.COUNTS``.

    ``echo`` prints the JAX solver's progress lines at the configured
    verbosity; it is for a solve of ONE instance (:func:`solve`)."""

    def __init__(self, problem: Problem, config: Optional[IPMConfig] = None,
                 echo: bool = False):
        cfg = config if config is not None else IPMConfig()
        self.problem = problem
        self.config = cfg.resolve_mu_strategy(problem.nineq)
        self.echo = echo and self.config.verbosity > 0
        self.has_ineq = problem.nineq > 0
        self.unconstrained = problem.ncon == 0

    # ------------------------------------------------------------------
    def direction(self, st: SolverState, p):
        """Newton direction (reference pyipm.py:1717-1721; JAX
        solver.py:284-329): the slack-eliminated condensed system by
        default, its Mehrotra predictor-corrector under
        ``mu_strategy='mehrotra'`` (which also sets each instance's mu),
        the full (D+2N+M)^2 KKT matrix with ``linear_solver='ldlt'`` or
        ``'lu'``.  Returns (dz, st) with delta and the retries updated."""
        problem, cfg = self.problem, self.config
        if cfg.linear_solver == "condensed":
            if cfg.mu_strategy == "mehrotra" and problem.nineq:
                dz, mu_new, delta_new, retries = condensed_direction_mehrotra(
                    problem, cfg, st.x, st.s, st.lda, st.mu, st.delta,
                    cfg.mu_floor, p)
                st = st._replace(mu=mu_new)
            else:
                dz, delta_new, retries = condensed_direction(
                    problem, cfg, st.x, st.s, st.lda, st.mu, st.delta, p)
        else:
            g = -K.grad(problem, st.x, st.s, st.lda, st.mu, p)
            H = K.kkt_matrix(problem, st.x, st.s, st.lda, st.mu, p)
            dz, delta_new, retries = reg_solve_kkt(
                H, g, st.delta, st.mu, nvar=problem.nvar, neq=problem.neq,
                nineq=problem.nineq, eps=cfg.eps, reg_coef=cfg.reg_coef,
                eta=cfg.eta, beta=cfg.beta, delta0=cfg.delta0,
                max_retries=cfg.max_reg_retries, block=cfg.ldlt_block,
                method=cfg.linear_solver)
        return dz, st._replace(delta=delta_new,
                               reg_retries=st.reg_retries + retries)

    def direction_lbfgs(self, st: SolverState, p):
        """Memory update and the compact direction (reference pyipm.py:
        1702-1713).  The update is skipped only on the very first inner
        iteration of the solve (the reference's ``inner > 0 or outer > 0``
        gate, pyipm.py:1705): it is computed for every instance and kept
        where that gate holds."""
        problem, cfg = self.problem, self.config
        D = problem.nvar
        not_first = (st.outer > 0) | (st.inner > 0)
        g_old = -K.grad(problem, st.x_old, st.s, st.lda, st.mu, p)
        g_new = -K.grad(problem, st.x, st.s, st.lda, st.mu, p)
        mem = lbfgs_update(
            st.lbfgs, st.x - st.x_old, g_old[:, :D] - g_new[:, :D],
            constrained=problem.ncon > 0, eps=cfg.eps, zeta0=cfg.zeta0,
            fail_max=cfg.lbfgs_fail_max)
        if (self.echo and cfg.verbosity > 2 and bool(not_first[0])
                and int(mem.count[0]) == 0 < int(st.lbfgs.count[0])):
            # a count that falls to 0 is a reset (pyipm.py:1366-1367)
            print("Max failures reached, resetting storage arrays.")
        st = st._replace(
            lbfgs=_tree(lambda a, b: _where(not_first, a, b), mem, st.lbfgs),
            x_old=_where(not_first, st.x, st.x_old),
            g=_where(not_first, g_new, st.g))
        dz = lbfgs_direction(problem, cfg, st.lbfgs, st.x, st.s, st.lda,
                             st.g, st.mu, p)
        return dz, st

    def _print_iteration(self, st: SolverState, p):
        """The JAX solver's per-iteration lines (solver.py:362-371) for a
        batch of one."""
        problem, cfg = self.problem, self.config
        if problem.nineq:
            print(f"* INNER ITERATION {int(st.inner[0]) + 1}")
        else:
            print(f"ITERATION {int(st.iter_count[0]) + 1}")
        if cfg.verbosity > 1:
            print(f"f(x) = {problem.f_val(st.x, p)[0].cpu().numpy()}")
        if cfg.verbosity > 2:
            k = st.kkt[0].cpu().numpy()
            print(f"|dL/dx| = {k[0]}, |dL/ds| = {k[1]}, |ce| = {k[2]}, "
                  f"|ci-s| = {k[3]}")

    def inner_iter(self, st: SolverState, p) -> SolverState:
        """One primal-dual iteration for every instance of ``st`` (the
        body of the reference's inner loop, pyipm.py:1672-1770)."""
        problem, cfg = self.problem, self.config
        D, M, N = problem.nvar, problem.neq, problem.nineq
        dtype = st.x.dtype
        tiny = torch.finfo(dtype).tiny
        if self.echo:
            self._print_iteration(st, p)

        dev = st.x.device
        with profiling.annotate("ipm-direction", dev):
            if cfg.lbfgs:
                dz, st = self.direction_lbfgs(st, p)
            else:
                dz, st = self.direction(st, p)

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

        with profiling.annotate("ipm-line-search", dev):
            res = search(problem, cfg, st.x, st.s, st.lda, dz, a_s, a_l,
                         st.mu, st.nu, st.signal, p)
        if self.echo and cfg.verbosity > 2:
            # line-search notices (reference pyipm.py:1485-1487, 1496-1500)
            if bool(res.soc[0]):
                print("Second-order feasibility correction accepted")
            if int(res.signal[0]) == -2:
                print("Search direction is unreliable to machine precision.")
        st = st._replace(x=res.x, s=res.s, lda=res.lda, signal=res.signal,
                         alpha=res.alpha, iter_count=st.iter_count + 1)
        with profiling.annotate("ipm-kkt-residual", dev):
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
            if (self.echo and cfg.verbosity > 2
                    and int(st.signal[0]) == -3):
                print("Non-finite iterate detected; terminating.")

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

    # the loop engine's hooks
    def f_val(self, st: SolverState, p):
        return self.problem.f_val(st.x, p)

    def centrality_stats(self, st: SolverState, p):
        sli = st.s * st.lda[:, self.problem.neq:]
        return (torch.sum(sli, dim=-1), torch.amin(sli, dim=-1),
                self.problem.nineq)

    def take(self, st: SolverState, ids, p):
        return _rows(st, ids), take(p, ids)

    def put(self, st: SolverState, ids, sub: SolverState) -> SolverState:
        return _put(st, ids, sub)

    def history_row(self, sub: SolverState) -> MetricsHistory:
        return MetricsHistory(sub.kkt, sub.mu, sub.nu, sub.alpha, sub.delta)

    # ------------------------------------------------------------------
    @_phase("ipm-init")
    def init_state(self, x0, p=(), s0=None, lda0=None, mu0=None,
                   nu0=None) -> SolverState:
        """Initialization (reference pyipm.py:1596-1651).

        ``mu0``/``nu0`` (a number or a (B,) tensor) override the configured
        initial barrier and penalty values, the explicit form of the
        reference's warm start, where mu and nu keep their final values
        across solves (pyipm.py:273-275, 363-364).  With N = 0 mu stays
        pinned at Ktol (pyipm.py:1606)."""
        problem, cfg = self.problem, self.config
        D, M, N = problem.nvar, problem.neq, problem.nineq
        dtype = cfg.torch_dtype
        if self.echo:
            print("Searching for a feasible local minimizer using "
                  + ("L-BFGS to approximate the Hessian." if cfg.lbfgs
                     else "the exact Hessian."))
        x = x0.to(dtype).reshape(-1, D)
        B = x.shape[0]

        def full(v, given=None):
            if given is None:
                return x.new_full((B,), v)
            return torch.as_tensor(given, dtype=dtype,
                                   device=x.device).expand(B).clone()

        if N:
            s = (K.init_slack(problem, x, cfg.Ktol, p) if s0 is None
                 else s0.to(dtype).reshape(B, N))
            mu = full(cfg.mu, mu0)
        else:
            s = x.new_zeros((B, 0))
            mu = full(cfg.Ktol)
        if M + N:
            lda = (K.init_lambda(problem, x, cfg.Ktol, p) if lda0 is None
                   else lda0.to(dtype).reshape(B, M + N))
        else:
            lda = x.new_zeros((B, 0))
        kkt0 = K.kkt_norms(problem, x, s, lda, mu, p)
        f_past = (problem.f_val(x, p) if cfg.Ftol is not None
                  else x.new_zeros((B,)))
        def i32():
            return torch.zeros((B,), dtype=torch.int32, device=x.device)

        def no():
            return torch.zeros((B,), dtype=torch.bool, device=x.device)

        extra = {}
        if cfg.lbfgs:
            extra = dict(
                lbfgs=lbfgs_init(B, D, cfg.lbfgs_mem, cfg.zeta0, dtype,
                                 x.device),
                x_old=x, g=-K.grad(problem, x, s, lda, mu, p))
        if cfg.trace_metrics:
            extra["hist"] = _empty_history(x, cfg.niter * cfg.miter)
        return SolverState(
            x=x, s=s, lda=lda, mu=mu, nu=full(cfg.nu, nu0),
            delta=full(0.0), kkt=kkt0, signal=i32(), iter_count=i32(),
            outer=i32(), inner=i32(), inner_done=no(), in_inner=no(),
            f_past=f_past, alpha=full(0.0), reg_retries=i32(), **extra)

    @_phase("ipm-finalize")
    def finalize(self, st: SolverState, p=()) -> SolverResult:
        return SolverResult(
            x=st.x, s=st.s, lda=st.lda, fval=self.problem.f_val(st.x, p),
            kkt=st.kkt, signal=st.signal, iter_count=st.iter_count,
            outer=st.outer, inner=st.inner, mu=st.mu, nu=st.nu,
            delta=st.delta, reg_retries=st.reg_retries,
            hist=(st.hist if st.hist is not None
                  else _empty_history(st.x, 0)))

    def __call__(self, x0, params=(), s0=None, lda0=None, mu0=None,
                 nu0=None) -> SolverResult:
        st = self.init_state(x0, params, s0, lda0, mu0, nu0)
        return self.finalize(self.run(st, params), params)


def make_solver(problem: Problem,
                config: Optional[IPMConfig] = None) -> BatchSolver:
    """Build the batch-first solver for (problem, config)."""
    return BatchSolver(problem, config)


def solve(problem: Problem, x0, config: Optional[IPMConfig] = None,
          s0=None, lda0=None, params=(), mu0=None,
          nu0=None) -> SolverResult:
    """Solve ONE instance: ``x0`` (D,), ``params`` that instance's data.
    Runs as a batch of one, prints the JAX solver's progress lines at
    ``verbosity > 0``, and returns unbatched fields."""
    p1 = tuple(t.unsqueeze(0) for t in params)
    if hasattr(params, "_fields"):
        p1 = type(params)(*p1)
    res = BatchSolver(problem, config, echo=True)(
        x0.reshape(1, -1), p1,
        None if s0 is None else s0.reshape(1, -1),
        None if lda0 is None else lda0.reshape(1, -1), mu0, nu0)
    return _tree(lambda t: t[0], res)
