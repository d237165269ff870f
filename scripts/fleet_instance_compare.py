"""Hold one instance of ``chip_smoke.py``'s mixed fleet (phase 16) to
itself across devices and packages, then step it one inner iteration at a
time and stop at the first branch that differs.

    python scripts/fleet_instance_compare.py BUCKET INDEX
        [--dtype float32|float64] [--iters N] [--context alone|bucket]
        [--no-bucket-runs] [--no-jax] [--restart] [--plain-solve]

BUCKET is one of phase 16's buckets (portfolio, svm, maxent, mpc,
box_qp), drawn by ``chip_smoke.mixed_buckets`` with the phase's seed.
INDEX is an instance of it, or ``auto``: the first instance whose signal
(else whose iteration count) differs between the card and the CPU in the
whole-bucket runs.

The sides are ``cuda`` (the port on the card, where there is one),
``cpu`` (the port on the CPU, the reference phase 16 holds the card to)
and ``jax`` (the JAX package on the CPU, where ``jax`` imports; box_qp
has no JAX counterpart).

1. Outcomes.  Unless ``--no-bucket-runs``, the whole bucket on each of
   the port's sides (``chip_smoke.solve_bucket``, phase 16's call), held
   card against CPU by phase 16's own ``chip_smoke.card_against_cpu``
   (what it would raise is printed, not raised).  Then each side's signal
   and iteration count for the instance alone (a batch of one: the port's
   ``BatchSolver``, the JAX package's vmapped ``make_*_batch_solver``)
   beside its count inside the bucket.
2. Steps.  Every side starts from the instance's x0 and takes one inner
   iteration at a time (the port: flat steps until the instance's
   iteration count moves; the JAX package: ``run_budget(st, 1)``).  With
   ``--context bucket`` the port's sides step the whole bucket in
   lockstep (``BatchSolver.flat_step``) and read the instance's row; the
   JAX side always steps the instance alone.  Per iteration and side: mu,
   nu, delta, the retries of this step (inertia escalations and residual
   gate firings together, as both packages count them), the merit penalty's
   update (the barrier slope grad(phi_barrier) . dz and the l1
   infeasibility |c|_1 it is divided by), alpha_smax,
   alpha_lmax and the accepted alpha, the line search's branch (``full``,
   ``soc``, ``backtrack k``, ``abort``) with phi0, the Armijo right-hand
   side and phi at the full step and at the trials walked (first three and
   the last), the four KKT norms in the working precision and re-evaluated
   in float64 at the same iterate (``kkt64``), and max |x - x_cpu|.  The
   branch comes from the side's own package: its direction, penalty update
   and ``search`` rerun on the state before the step (``exact`` says
   whether that rerun lands on the step's alpha and signal); only phi and
   the right-hand side at each trial are evaluated here.  When the
   retries of a step differ, the residual gate's normwise backward error
   of the first solve at delta 0 (each package's own condensed system) is
   printed for the substitution solve (the port's kernel 2 and its plain
   version, the JAX package's Pallas kernel on a TPU) and for the
   log-depth-inverse solve (``ldlt_solve_inv``, the JAX package's CPU
   path), both in the working precision and in float64, beside sqrt(eps).
   The run stops after the first iteration whose branch key (outer and
   inner position, signal, retries of the step, line-search branch)
   differs from the CPU's, and names the quantity.
3. ``--restart``: the card and the JAX side also take each step from the
   CPU's state before it (``from cpu``); what differs then is that
   step's own arithmetic, not what earlier steps accumulated.
   ``--plain-solve`` runs the card with the plain solve in place of
   kernel 2 (kernel 1 still factors): whether a card-only outcome follows
   the kernel's rounding order.

Runs on the CPU against the JAX package (``JAX_PLATFORMS=cpu``), and on a
machine with a card; ``--no-jax`` leaves the JAX side out.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

BUCKETS = ("portfolio", "svm", "maxent", "mpc", "box_qp")
FIELDS = ("x", "s", "lda", "mu", "nu", "delta", "kkt", "signal",
          "iter_count", "outer", "inner", "inner_done", "in_inner",
          "f_past", "alpha", "reg_retries")
SHOW_TRIALS = 3


def counts(sig):
    return {int(k): int(v) for k, v in zip(*np.unique(sig,
                                                      return_counts=True))}


def fmt(v):
    return "[" + " ".join(f"{float(u):.6e}" for u in np.ravel(v)) + "]"


def branch_of(out, alpha, soc, aborted, trial, shrink_base, cfg):
    """Name the branch a package's ``search`` took from its outcome
    (``alpha``, ``soc``, ``aborted``) and read phi and the Armijo
    right-hand side at the trials it walked (the first SHOW_TRIALS and the
    last).  ``trial(n)``: (a_n, phi(a_n), rhs(a_n)) at a_n = a_s tau^n;
    ``shrink_base(n)``: tau^n times the step norm, the abort test's
    quantity."""
    out.update(zip(("phi_full", "rhs_full"), trial(0)[1:]))
    if soc:
        return dict(out, branch="soc", alpha=alpha)
    if not aborted and alpha == out["a_s"]:
        return dict(out, branch="full", alpha=alpha)
    if aborted:
        n = 1
        while shrink_base(n) >= cfg.eps and n < cfg.max_backtrack:
            n += 1
    else:
        n = max(1, round(np.log(alpha / out["a_s"]) / np.log(cfg.tau)))
    trials = [trial(j) for j in sorted(set(range(1, min(n, SHOW_TRIALS)
                                                 + 1)) | {n})]
    if aborted:
        return dict(out, branch="abort", alpha=0.0, trials=trials,
                    abort_test=shrink_base(n))
    return dict(out, branch=f"backtrack {n}", alpha=alpha, trials=trials)


# ----------------------------------------------------------------------
# the port on one device
class PortSide:
    def __init__(self, name, device, bucket, cfg):
        from pyipm_tpu_torch.core.solver import BatchSolver
        self.name, self.dev, self.cfg = name, torch.device(device), cfg
        prob, data, x0 = bucket
        dt = cfg.torch_dtype
        self.prob = prob
        self.data = cs.retype(data, (t.to(self.dev, dt)
                                     if t.is_floating_point()
                                     else t.to(self.dev) for t in data))
        self.x0 = x0.to(self.dev, dt)
        self.solver = BatchSolver(prob, cfg)

    def rows(self, ids):
        from pyipm_tpu_torch.core.linesearch import take
        return take(self.data, torch.as_tensor(ids, device=self.dev))

    def alone(self, i):
        r = self.solver(self.x0[i:i + 1], self.rows([i]))
        return int(r.signal[0]), int(r.iter_count[0])

    # stepping ---------------------------------------------------------
    def start(self, ids, k):
        self.ids, self.k = ids, k
        self.p = self.rows(ids)
        with torch.no_grad():
            self.st = self.solver.init_state(self.x0[ids], self.p)

    def _step(self, st):
        """Flat steps until row k's iteration count moves; also returns the
        state before the last flat step and the rows it stepped."""
        cfg, k = self.cfg, self.k
        last = None
        with torch.no_grad():
            before = int(st.iter_count[k])
            while int(st.iter_count[k]) == before:
                running = (st.outer < cfg.niter) & (st.signal == 0)
                if not bool(running[k]):
                    break
                last = (st, running)
                st = self.solver.flat_step(st, running, self.p)
        return st, last

    def step(self):
        self.before = self.st
        self.st, self.last = self._step(self.st)

    def step_from(self, fields):
        """One step from another side's state (every row of the batch)."""
        st = self.st._replace(**{
            f: torch.as_tensor(v).to(self.dev, getattr(self.st, f).dtype)
            for f, v in fields.items()})
        return self._step(st)[0]

    def stepped(self):
        """The state, data and row of k of the subset of instances that the
        last flat step took an inner iteration on (``LoopEngine.flat_step``
        gathers them), so that a recomputation runs on the same batch."""
        from pyipm_tpu_torch.core.linesearch import take
        from pyipm_tpu_torch.core.solver import _rows
        st, running = self.last
        cfg = self.cfg
        active = (running & st.in_inner & (st.inner < cfg.miter)
                  & (st.signal == 0) & ~st.inner_done)
        mutol = torch.clamp(st.mu, min=cfg.Ktol)
        conv_in = torch.all(st.kkt <= mutol[:, None], dim=-1)
        ids = torch.nonzero(active & ~conv_in).flatten()
        k = int(torch.nonzero(ids == self.k).flatten()[0])
        return _rows(st, ids), take(self.p, ids), k

    def fields(self, st=None):
        st = self.st if st is None else st
        return {f: getattr(st, f).cpu().numpy() for f in FIELDS}

    def row(self, st=None):
        return {f: v[self.k] for f, v in self.fields(st).items()}

    def anatomy(self):
        """The branch of the last step of row k: the port's direction,
        merit penalty update and ``search`` rerun on the batch that step
        ran on."""
        from pyipm_tpu_torch.core import kkt as K
        from pyipm_tpu_torch.core.linesearch import max_step_ftb, search, take
        from pyipm_tpu_torch.core.updates import nu_threshold
        prob, cfg = self.prob, self.cfg
        st, p, row = self.stepped()
        D, M, N = prob.nvar, prob.neq, prob.nineq
        with torch.no_grad():
            dz, st1 = self.solver.direction(st, p)
            nu = st.nu
            bdot = cl1 = torch.zeros_like(nu)
            if prob.ncon:
                dz = torch.cat([dz[:, :D + N], -dz[:, D + N:]], dim=-1)
                bdot = torch.sum(K.barrier_cost_grad(prob, st.x, st.s, st.mu,
                                                     p) * dz[:, :D + N], -1)
                cl1 = torch.sum(torch.abs(K.con(prob, st.x, st.s, p)), -1)
                nu = torch.maximum(nu, nu_threshold(
                    bdot, cl1, cfg.rho, torch.finfo(st.x.dtype).tiny))
            one = st.x.new_ones(st.x.shape[:1])
            a_s = max_step_ftb(st.s, dz[:, D:D + N], cfg.tau) if N else one
            a_l = (max_step_ftb(st.lda[:, M:], dz[:, D + N + M:], cfg.tau)
                   if N else one)
            res = search(prob, cfg, st.x, st.s, st.lda, dz, a_s, a_l, st.mu,
                         nu, st.signal, p)
            k = slice(row, row + 1)
            x0, s0, mu, nu_k = st.x[k], st.s[k], st.mu[k], nu[k]
            dx, ds, pk = dz[k, :D], dz[k, D:D + N], take(p, [row])
            phi0 = K.phi(prob, x0, s0, mu, nu_k, pk)
            dphi0 = K.dphi(prob, x0, s0, dz[k, :D + N], mu, nu_k, pk)
            slack = 10.0 * cfg.eps * (1.0 + torch.abs(phi0))
            tau, eta = (torch.as_tensor(v, dtype=x0.dtype, device=x0.device)
                        for v in (cfg.tau, cfg.eta))
            base = torch.linalg.vector_norm(a_s[k, None] * dx, dim=-1)
            if N:
                base = torch.sqrt(base ** 2 + torch.linalg.vector_norm(
                    a_l[k, None] * ds, dim=-1) ** 2)

            def shrink(n):
                return torch.pow(tau, torch.as_tensor(
                    float(n), dtype=tau.dtype, device=tau.device))

            def trial(n):
                a = a_s[k] * shrink(n)
                ph = K.phi(prob, x0 + a[:, None] * dx, s0 + a[:, None] * ds,
                           mu, nu_k, pk)
                return (float(a), float(ph),
                        float(phi0 + a * eta * dphi0 + slack))

            out = dict(retries=int(st1.reg_retries[row]
                                   - st.reg_retries[row]),
                       delta=float(st1.delta[row]), nu=float(nu[row]),
                       bdot=float(bdot[row]), con_l1=float(cl1[row]),
                       a_s=float(a_s[row]), a_l=float(a_l[row]),
                       phi0=float(phi0))
            return branch_of(out, float(res.alpha[row]), bool(res.soc[row]),
                             int(res.signal[row]) == -2, trial,
                             lambda n: float(shrink(n) * base), cfg)

    def gate_probe(self, st):
        """Normwise backward error of the condensed system's first refined
        solve at delta 0 (``reg_solve_kkt``'s residual gate), by the
        substitution solve and by the log-depth-inverse solve, in the
        working precision and in float64."""
        from pyipm_tpu_torch.core import kkt as K
        from pyipm_tpu_torch.ops import linalg as lin
        from pyipm_tpu_torch.ops.condensed import _Condensed, _split
        from pyipm_tpu_torch.ops.small_ldlt import ldlt_factor_small_ref
        k = slice(self.k, self.k + 1)
        pk = self.rows([self.ids[self.k]])
        with torch.no_grad():
            g = _split(self.prob, -K.grad(self.prob, st.x[k], st.s[k],
                                          st.lda[k], st.mu[k], pk))
            sysm = _Condensed(self.prob, st.x[k], st.s[k], st.lda[k], pk)
            H0, b0 = sysm.Kc.cpu(), sysm.rhs(*g).cpu()
        out = {}
        for dt in (H0.dtype, torch.float64):
            H, b = H0.to(dt), b0.to(dt)
            Hs, dsc = lin.ruiz_scale(H)
            L, d = ldlt_factor_small_ref(Hs)
            Linv = lin.unit_lower_inverse(L)
            safe = torch.where(d.abs() > 0, d, torch.ones_like(d))

            def inv(r):
                y = lin.matvec(Linv, dsc * r) / safe
                return dsc * lin.matvec(Linv.transpose(1, 2), y)

            def sub(r):
                return lin.ldlt_solve_small(L, d, r, scale=dsc)

            for name, solve in (("subst", sub), ("inv", inv)):
                y = solve(b)
                rn = lin._norm(b - lin.matvec(H, y))
                y2 = y + solve(b - lin.matvec(H, y))
                rn2 = lin._norm(b - lin.matvec(H, y2))
                if bool(rn2 < rn):
                    y, rn = y2, rn2
                berr = rn / (torch.linalg.matrix_norm(H) * lin._norm(y)
                             + lin._norm(b))
                tag = "" if dt == H0.dtype else "64"
                out[f"berr_{name}{tag}"] = float(berr)
        out["gate_tol"] = float(np.sqrt(self.cfg.eps))
        return out


# ----------------------------------------------------------------------
# the JAX package on the CPU, the instance alone
class JaxSide:
    name = "jax"

    def __init__(self, bucket_name, bucket, cfg):
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp
        from pyipm_tpu.config import IPMConfig as JCfg
        from pyipm_tpu.models import applications as japp
        self.jax, self.jnp, self.japp = jax, jnp, japp
        prob, data, x0 = bucket
        self.dt = cfg.float_dtype
        self.jcfg = JCfg(float_dtype=self.dt, verbosity=0, Ktol=cfg.Ktol)
        cls, make = {
            "portfolio": (japp.PortfolioData, japp.make_portfolio_problem),
            "svm": (japp.SVMData, japp.make_svm_problem),
            "maxent": (japp.MaxEntData, japp.make_maxent_problem),
            "mpc": (japp.MPCData,
                    lambda d: japp.make_mpc_problem(d, cs.MPC_T)),
        }[bucket_name]
        self.cls, self.make, self.bucket_name = cls, make, bucket_name
        self.arrays = {f: getattr(data, f).cpu().numpy() for f in cls._fields}
        self.x0 = x0.cpu().numpy().astype(self.dt)

    def data(self, ids):
        return self.cls(*(self.jnp.asarray(
            self.arrays[f][ids].astype(self.dt)
            if self.arrays[f].dtype.kind == "f" else self.arrays[f][ids])
            for f in self.cls._fields))

    def alone(self, i):
        size = {"portfolio": cs.PORTFOLIO_D, "svm": cs.SVM_N,
                "maxent": cs.MAXENT_D, "mpc": cs.MPC_T}[self.bucket_name]
        solver = getattr(self.japp, f"make_{self.bucket_name}_batch_solver")(
            self.jcfg, size)
        r = solver(self.jnp.asarray(self.x0[i:i + 1]), self.data([i]))
        return int(r.signal[0]), int(r.iter_count[0])

    def start(self, i):
        from pyipm_tpu.core.solver import make_solver
        row = self.cls(*(a[0] for a in self.data([i])))
        self.prob = self.make(row)
        fn = make_solver(self.prob, self.jcfg)
        self.run_budget = self.jax.jit(fn.run_budget)
        self.st = self.jax.jit(fn.init_state)(self.jnp.asarray(self.x0[i]))

    def step(self):
        self.before = self.st
        self.st = self.run_budget(self.st, 1)

    def with_fields(self, fields):
        return self.st._replace(**{
            f: self.jnp.asarray(np.asarray(v), getattr(self.st, f).dtype)
            for f, v in fields.items()})

    def step_from(self, fields):
        return self.run_budget(self.with_fields(fields), 1)

    def row(self, st=None):
        st = self.st if st is None else st
        return {f: np.asarray(getattr(st, f)) for f in FIELDS}

    def anatomy(self):
        """The branch of the last step: the JAX package's direction,
        penalty update and ``search`` (each jitted on its own) rerun from
        the state before it, with the barrier of an outer epilogue that ran
        before the iteration."""
        jax, jnp = self.jax, self.jnp
        st = self.before
        if int(self.st.outer) != int(st.outer):
            st = st._replace(mu=self.st.mu)
        from pyipm_tpu.core import kkt as K
        from pyipm_tpu.core.linesearch import max_step_ftb, search
        from pyipm_tpu.core.updates import nu_threshold
        from pyipm_tpu.ops.condensed import condensed_direction
        prob, cfg = self.prob, self.jcfg
        D, M, N = prob.nvar, prob.neq, prob.nineq
        dtype = st.x.dtype
        dz, delta_new, retries = jax.jit(
            lambda x, s, l, mu, d: condensed_direction(prob, cfg, x, s, l, mu,
                                                       d))(
            st.x, st.s, st.lda, st.mu, st.delta)
        nu = st.nu
        bdot = cl1 = jnp.zeros((), dtype)
        if prob.ncon:
            dz = dz.at[D + N:].multiply(-1)
            bdot = K.barrier_cost_grad(prob, st.x, st.s, st.mu) @ dz[:D + N]
            cl1 = jnp.sum(jnp.abs(K.con(prob, st.x, st.s)))
            nu = jnp.maximum(nu, nu_threshold(bdot, cl1, cfg.rho,
                                              float(np.finfo(dtype).tiny)))
        one = jnp.ones((), dtype)
        a_s = max_step_ftb(st.s, dz[D:D + N], cfg.tau) if N else one
        a_l = max_step_ftb(st.lda[M:], dz[D + N + M:], cfg.tau) if N else one
        res = jax.jit(lambda *a: search(prob, cfg, *a))(
            st.x, st.s, st.lda, dz, a_s, a_l, st.mu, nu, st.signal)
        x0, s0, mu = st.x, st.s, st.mu
        dx, ds = dz[:D], dz[D:D + N]
        phi_j = jax.jit(lambda x, s: K.phi(prob, x, s, mu, nu))
        phi0 = phi_j(x0, s0)
        dphi0 = K.dphi(prob, x0, s0, dz[:D + N], mu, nu)
        slack = 10.0 * jnp.asarray(cfg.eps, dtype) * (1.0 + jnp.abs(phi0))
        tau, eta = jnp.asarray(cfg.tau, dtype), jnp.asarray(cfg.eta, dtype)
        base = jnp.linalg.norm(a_s * dx)
        if N:
            base = jnp.sqrt(base ** 2 + jnp.linalg.norm(a_l * ds) ** 2)

        def shrink(n):
            return jnp.power(tau, jnp.asarray(n, dtype))

        def trial(n):
            a = a_s * shrink(n)
            return (float(a), float(phi_j(x0 + a * dx, s0 + a * ds)),
                    float(phi0 + a * eta * dphi0 + slack))

        out = dict(retries=int(retries), delta=float(delta_new),
                   nu=float(nu), bdot=float(bdot), con_l1=float(cl1),
                   a_s=float(a_s), a_l=float(a_l), phi0=float(phi0))
        return branch_of(out, float(res.alpha), bool(res.soc),
                         int(res.signal) == -2, trial,
                         lambda n: float(shrink(n) * base), cfg)

    def gate_probe(self, st):
        """The port's gate probe by the JAX package's own arithmetic: its
        condensed system (``condensed_direction``'s, taken where it calls
        ``reg_solve_kkt``), Ruiz scaling, unrolled factor, and the
        log-depth-inverse solve of its CPU path beside a substitution
        solve."""
        jax, jnp = self.jax, self.jnp
        from jax.scipy.linalg import solve_triangular
        from pyipm_tpu.ops import condensed as jc
        from pyipm_tpu.ops import linalg as jlin
        from pyipm_tpu.ops import pallas_ldlt as pk

        class Taken(Exception):
            pass

        def take_system(Kc, rhs, *args, **kw):
            raise Taken(Kc, rhs)

        def assemble(x, s, lda, mu, delta):
            solve, jc.reg_solve_kkt = jc.reg_solve_kkt, take_system
            try:
                jc.condensed_direction(self.prob, self.jcfg, x, s, lda, mu,
                                       delta)
            except Taken as t:
                return t.args
            finally:
                jc.reg_solve_kkt = solve

        def berr(H, b, solve1):
            Hs, dsc = jlin.ruiz_scale(H)
            L, d = pk.ldlt_factor_small(Hs)

            def solve(r):
                return dsc * solve1(L, d, dsc * r)
            y = solve(b)
            rn = jnp.linalg.norm(b - H @ y)
            y2 = y + solve(b - H @ y)
            rn2 = jnp.linalg.norm(b - H @ y2)
            y, rn = jnp.where(rn2 < rn, y2, y), jnp.minimum(rn, rn2)
            return rn / (jnp.linalg.norm(H) * jnp.linalg.norm(y)
                         + jnp.linalg.norm(b)
                         + jnp.finfo(H.dtype).tiny)

        def subst(L, d, b):
            safe = jnp.where(jnp.abs(d) > 0, d, jnp.ones((), L.dtype))
            y = solve_triangular(L, b, lower=True, unit_diagonal=True)
            return solve_triangular(L.T, y / safe, lower=False,
                                    unit_diagonal=True)

        H, b = jax.jit(assemble)(st.x, st.s, st.lda, st.mu, st.delta)
        out = {}
        for tag, (Hc, bc) in (("", (H, b)), ("64", (H.astype(jnp.float64),
                                                    b.astype(jnp.float64)))):
            out[f"berr_subst{tag}"] = float(jax.jit(
                lambda h, v: berr(h, v, subst))(Hc, bc))
            out[f"berr_inv{tag}"] = float(jax.jit(
                lambda h, v: berr(h, v, pk.ldlt_solve_small))(Hc, bc))
        out["gate_tol"] = float(np.sqrt(self.jcfg.eps))
        return out


# ----------------------------------------------------------------------
def kkt64(prob, data64, r):
    """The four KKT norms at row ``r``'s iterate, in float64 (the port's
    ``kkt_norms`` on float64 copies of the instance's data)."""
    from pyipm_tpu_torch.core import kkt as K

    def t(v):
        return torch.as_tensor(np.asarray(v, np.float64))[None]
    with torch.no_grad():
        return K.kkt_norms(prob, t(r["x"]), t(r["s"]), t(r["lda"]),
                           t(r["mu"]).reshape(1), data64)[0].numpy()


def grad_operand(prob, data64, r):
    """The largest entry of grad f and of the constraint term J lambda at
    row ``r``'s iterate (float64): the scale of dL/dx's rounding error."""
    from pyipm_tpu_torch.core import kkt as K

    def t(v):
        return torch.as_tensor(np.asarray(v, np.float64))[None]
    with torch.no_grad():
        gf = prob.grad_f(t(r["x"]), data64)
        jl = torch.matmul(K.jaco(prob, t(r["x"]), data64)[:, :prob.nvar],
                          t(r["lda"])[..., None])[..., 0]
    return float(torch.maximum(gf.abs().max(), jl.abs().max()))


def branch_key(r, before, an):
    return (int(r["outer"]), int(r["inner"]), int(r["signal"]),
            int(r["reg_retries"]) - int(before["reg_retries"]),
            an["branch"] if an else None)


def print_row(name, r, before, an, k64, x_ref):
    retries = int(r["reg_retries"]) - int(before["reg_retries"])
    line = (f"  {name:16s} it {int(r['iter_count'])} outer {int(r['outer'])} "
            f"inner {int(r['inner'])} sig {int(r['signal'])} mu "
            f"{float(r['mu']):.6e} nu {float(r['nu']):.6e} delta "
            f"{float(r['delta']):.6e} retries {retries} alpha "
            f"{float(r['alpha']):.9e} kkt {fmt(r['kkt'])} kkt64 {fmt(k64)}")
    if x_ref is not None:
        line += f" max|x - x_cpu| {np.abs(r['x'] - x_ref).max():.3e}"
    print(line)
    if an:
        exact = (an["alpha"] == float(r["alpha"])
                 and (an["branch"] == "abort") == (int(r["signal"]) == -2))
        desc = (f"    branch {an['branch']} (exact {exact}) nu update: "
                f"barrier slope {an['bdot']:.9e} |c|_1 {an['con_l1']:.9e} -> "
                f"nu {an['nu']:.6e}; a_s "
                f"{an['a_s']:.9e} a_l {an['a_l']:.9e} phi0 {an['phi0']:.9e} "
                f"full: phi {an['phi_full']:.9e} rhs {an['rhs_full']:.9e}")
        if "abort_test" in an:
            desc += f" abort_test {an['abort_test']:.9e}"
        print(desc)
        trials = an.get("trials", [])
        show = trials[:SHOW_TRIALS] + (trials[-1:] if len(trials)
                                       > SHOW_TRIALS else [])
        if show:
            print("    trials (a, phi, rhs): " + "; ".join(
                f"{a:.6e} {p:.9e} {q:.9e}" for a, p, q in show))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("bucket", choices=BUCKETS)
    ap.add_argument("index")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--context", default="alone",
                    choices=("alone", "bucket"))
    ap.add_argument("--no-bucket-runs", action="store_true")
    ap.add_argument("--no-jax", action="store_true")
    ap.add_argument("--restart", action="store_true")
    ap.add_argument("--plain-solve", action="store_true")
    args = ap.parse_args()

    from pyipm_tpu_torch import IPMConfig
    from pyipm_tpu_torch.ops import linalg, small_ldlt
    cfg = IPMConfig(float_dtype=args.dtype, verbosity=0, Ktol=1e-4)
    buckets = cs.mixed_buckets(torch.device("cpu"))
    bucket = buckets[args.bucket]
    prob, data, _ = bucket
    sides = [PortSide("cpu", "cpu", bucket, cfg)]
    if torch.cuda.is_available():
        sides.insert(0, PortSide("cuda", "cuda:0", bucket, cfg))
        if args.plain_solve:
            linalg.ldlt_solve_small = (lambda L, d, b, scale=None:
                                       small_ldlt.ldlt_solve_small_ref(
                                           L, d, b, scale))
            print("card: kernel 2 replaced by its plain version")
    jside = None
    if not args.no_jax and args.bucket != "box_qp":
        try:
            import jax  # noqa: F401
        except ImportError:
            print("jax does not import: no JAX side")
        else:
            jside = JaxSide(args.bucket, bucket, cfg)
    print(f"bucket {args.bucket} ({prob.nvar} variables, {prob.neq} "
          f"equalities, {prob.nineq} inequalities), {args.dtype}, Ktol "
          f"{cfg.Ktol}, sides {[s.name for s in sides]}"
          + (" + jax" if jside else ""), flush=True)

    runs, walls = {}, {}
    if not args.no_bucket_runs:
        for s in sides:
            t0 = time.perf_counter()
            res = cs.solve_bucket(prob, data, bucket[2], cfg, s.dev)
            walls[s.name] = time.perf_counter() - t0
            runs[s.name] = (res.signal.cpu().numpy(),
                            res.iter_count.cpu().numpy(), res)
            sig, its, _ = runs[s.name]
            print(f"  {s.name} bucket: signals {counts(sig)}, mean "
                  f"{its.mean():.6f}, max {its.max()} iterations, "
                  f"{walls[s.name]:.1f} s", flush=True)
        if "cuda" in runs:
            try:
                cs.card_against_cpu(args.bucket, runs["cuda"][2],
                                    runs["cpu"][2], walls["cpu"])
            except AssertionError as e:
                print(f"  phase 16 would raise: {e}")
    if args.index == "auto":
        if "cuda" not in runs:
            raise SystemExit("index auto needs the card and the bucket runs")
        (sg, ig, _), (sc, ic, _) = runs["cuda"], runs["cpu"]
        diff = np.flatnonzero(sg != sc)
        diff = diff if diff.size else np.flatnonzero(ig != ic)
        if not diff.size:
            print("card and CPU agree on every signal and iteration count")
            return
        i = int(diff[0])
    else:
        i = int(args.index)
    print(f"instance {i}", flush=True)
    for s in sides + ([jside] if jside else []):
        sig, its = s.alone(i)
        inb = (f"; in the bucket: signal {runs[s.name][0][i]}, "
               f"{runs[s.name][1][i]} iterations" if s.name in runs else "")
        print(f"  {s.name} alone: signal {sig}, {its} iterations{inb}",
              flush=True)

    # ------------------------------------------------------------------
    Bn = bucket[2].shape[0]
    ids, k = ([i], 0) if args.context == "alone" else (list(range(Bn)), i)
    for s in sides:
        s.start(ids, k)
    if jside:
        jside.start(i)
    from pyipm_tpu_torch.core.linesearch import take
    data64 = take(cs.retype(data, (t.double() if t.is_floating_point() else t
                                for t in data)), torch.as_tensor([i]))
    cpu = sides[-1]
    stepping = sides + ([jside] if jside else [])
    print(f"stepping ({args.context}; the JAX side alone)", flush=True)
    for _ in range(args.iters):
        for s in stepping:
            s.step()
        rows = {}
        keys = {}
        ref = cpu.row()
        for s in stepping:
            r, before = s.row(), s.row(s.before)
            moved = int(r["iter_count"]) != int(before["iter_count"])
            an = s.anatomy() if moved else None
            rows[s.name] = (r, before, an)
            keys[s.name] = branch_key(r, before, an)
            print_row(s.name, r, before, an, kkt64(prob, data64, r),
                      None if s is cpu else ref["x"])
        if args.restart:
            cpu_before = cpu.fields(cpu.before)
            for s in stepping:
                if s is cpu:
                    continue
                f = (cpu_before if isinstance(s, PortSide)
                     else {n: v[cpu.k] for n, v in cpu_before.items()})
                st = s.step_from(f)
                r = s.row(st)
                print_row(f"{s.name} from cpu", r, cpu.row(cpu.before), None,
                          kkt64(prob, data64, r), ref["x"])
        differ = [n for n in keys if keys[n] != keys["cpu"]]
        if differ:
            names = ("outer", "inner", "signal", "retries of the step",
                     "line-search branch")
            for n in differ:
                what = [names[j] for j in range(5)
                        if keys[n][j] != keys["cpu"][j]]
                print(f"first differing branch quantity, {n} against cpu: "
                      f"{', '.join(what)}: {keys[n]} against {keys['cpu']}")
                if "retries of the step" in what:
                    for s in stepping:
                        print(f"  {s.name} gate at delta 0, its own iterate: "
                              f"{s.gate_probe(s.before)}")
                    if jside:
                        f = {m: v[cpu.k] for m, v in
                             cpu.fields(cpu.before).items()}
                        print(f"  jax gate at delta 0, the cpu's iterate: "
                              f"{jside.gate_probe(jside.with_fields(f))}")
                if what[0] in ("outer", "inner", "signal"):
                    for m in (n, "cpu"):
                        b = rows[m][1]
                        print(f"  {m}: the loop tests before this step read "
                              f"kkt {fmt(b['kkt'])} (kkt64 "
                              f"{fmt(kkt64(prob, data64, b))}) against Ktol "
                              f"{cfg.Ktol} and mu {float(b['mu']):.6e}; "
                              f"dL/dx's largest operand "
                              f"{grad_operand(prob, data64, b):.6e}, eps "
                              f"{cfg.eps:.3e}")
            break
        if all(int(rows[n][0]["signal"]) != 0 for n in rows):
            print("every side has stopped with the same branches")
            break


if __name__ == "__main__":
    main()
