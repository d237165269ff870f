"""The block-separable Schur solver (counterpart of
``pyipm_tpu/parallel/schur.py``).

One large NLP in block-separable form,

    min   sum_k f_k(x_k)                  x_k in R^d, k = 1..K
    s.t.  ce_k(x_k) = 0,  ci_k(x_k) >= 0  (per block)
          cc(sum_k g_k(x_k)) = 0          (coupling equalities)
          cci(sum_k g_k(x_k)) >= 0        (coupling inequalities)

with its blocks split over the ranks of a mesh's ``model`` dimension.
Each rank factors its blocks' condensed (d + me)^2 systems
(``ops/linalg.batched_reg_factor``) and the coupling reduces to a small
replicated border system assembled from all-reduced per-block products
(the JAX package's module docstring, schur.py:35-64, states the algebra).

The JAX package runs the whole solve as one ``shard_map`` program; here
every rank runs the same eager program and the collectives are
``torch.distributed`` all-reduces through :class:`~pyipm_tpu_torch.
parallel.reduce.Reducer` (one process: identities).  Every decision that
changes replicated state is taken from a reduced value, so every rank
takes the same branch.  The loop is ``core/solver.LoopEngine`` with the
state a batch of one: the same ``SolverState``, with x and delta the
rank's (Kl, ...) block slabs, ``s`` the (s, sc) pair and ``lda`` the
(le, li, lc, lci) multipliers.

With ``cfg.lbfgs > 0`` each block keeps a compact L-BFGS memory (the
state's ``lbfgs``, every field with a leading block axis, and ``x_old``)
and the per-block factorization gives way to a Woodbury operator over a
diagonal base, O(d (2m + ni)) a block: no (d, d) matrix is ever formed
(JAX schur.py:772-891).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd, jacrev, vmap

from pyipm_tpu_torch import _sync
from pyipm_tpu_torch.config import IPMConfig
from pyipm_tpu_torch.core.lbfgs import (
    LBFGSState, _masked_mem, _padded_middle, lbfgs_init, lbfgs_update,
)
from pyipm_tpu_torch.core.linesearch import max_step_ftb, merit_line_search
from pyipm_tpu_torch.core.solver import (
    LoopEngine, MetricsHistory, SolverState, _phase,
)
from pyipm_tpu_torch.core.updates import nu_threshold
from pyipm_tpu_torch.models.applications import _cast
from pyipm_tpu_torch.models.random_nlp import resolve_device
from pyipm_tpu_torch.ops.linalg import _eq_reg_term, batched_reg_factor
from pyipm_tpu_torch.parallel.reduce import Reducer
from pyipm_tpu_torch.utils import profiling


# ----------------------------------------------------------------------
# problem specification
@dataclasses.dataclass(frozen=True, eq=False)
class BlockNLP:
    """Static description of a block-separable NLP (JAX schur.py:101-181).

    Every callable takes ``(x_k (d,), theta_k)`` with ``theta_k`` the
    block's slice of the data dict; ``cc``/``cci`` take ``(u (p,),
    ccdata)``.  ``hess_blk(x_k, theta_k, le_k, li_k, w) -> (d, d)``
    overrides the per-block Lagrangian Hessian, w = Jcc^T lc + Jcci^T lci.
    ``ci_identity`` declares ci = x - lb (Sigma on the diagonal);
    ``ce_mask_key`` / ``ci_mask_key`` name (K, me) / (K, ni) {0, 1}
    validity masks in theta (ragged blocks); ``linear_coupling`` declares
    cc affine in u (one collective fewer, fused)."""
    f_blk: Callable
    d: int
    ce_blk: Optional[Callable] = None
    me: int = 0
    ci_blk: Optional[Callable] = None
    ni: int = 0
    g_blk: Optional[Callable] = None
    cc: Optional[Callable] = None
    p: int = 0
    mc: int = 0
    cci: Optional[Callable] = None
    mci: int = 0
    hess_blk: Optional[Callable] = None
    ci_identity: bool = False
    ce_mask_key: Optional[str] = None
    ci_mask_key: Optional[str] = None
    linear_coupling: bool = False

    def __post_init__(self):
        def check(ok, msg):
            if not ok:
                raise ValueError(msg)

        check((self.me > 0) == (self.ce_blk is not None),
              "me > 0 exactly when ce_blk is given")
        check((self.ni > 0) == (self.ci_blk is not None),
              "ni > 0 exactly when ci_blk is given")
        check((self.mc > 0) == (self.cc is not None),
              "mc > 0 exactly when cc is given")
        check((self.mci > 0) == (self.cci is not None),
              "mci > 0 exactly when cci is given")
        if self.mc or self.mci:
            check(self.g_blk is not None and self.p > 0,
                  "coupling needs g_blk and p > 0")
        if self.ci_identity:
            check(self.ni == self.d, "ci_identity needs ci = x - lb")
        check(self.ce_mask_key is None or self.me > 0,
              "ce_mask_key needs me > 0")
        check(self.ci_mask_key is None or self.ni > 0,
              "ci_mask_key needs ni > 0")


class BlockResult(NamedTuple):
    x: torch.Tensor          # (K, d), every rank's blocks
    s: torch.Tensor          # (K, ni)
    le: torch.Tensor         # (K, me)
    li: torch.Tensor         # (K, ni)
    lc: torch.Tensor         # (mc,)
    sc: torch.Tensor         # (mci,)
    lci: torch.Tensor        # (mci,)
    fval: torch.Tensor       # ()
    kkt: torch.Tensor        # (4,)
    signal: torch.Tensor     # () int32
    iter_count: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor
    hist: MetricsHistory     # (T, ...) fields, T = 0 without trace_metrics


def box_ci(lb_key: str = "lb", ub_key: Optional[str] = None):
    """Per-block bounds as inequalities: ci_k = [x - lb] or
    [x - lb; ub - x], the bounds read from theta_k."""
    if ub_key is None:
        return lambda xk, th: xk - th[lb_key]
    return lambda xk, th: torch.cat([xk - th[lb_key], th[ub_key] - xk])


# ----------------------------------------------------------------------
class _Ops:
    """The per-rank mathematics of one (spec, config): the derivative
    layer, residuals, merit and the least-squares multipliers, on the
    rank's (Kl, ...) slabs with global scalars from the reducer (JAX
    schur.py:254-770)."""

    def __init__(self, spec: BlockNLP, cfg: IPMConfig, red: Reducer):
        self.spec, self.cfg, self.red = spec, cfg, red
        self.dtype = cfg.torch_dtype
        self.d, self.me, self.ni = spec.d, spec.me, spec.ni
        self.p, self.mc, self.mci = spec.p, spec.mc, spec.mci
        self.n = spec.d + spec.me
        self.has_barrier = spec.ni > 0 or spec.mci > 0
        self.has_cc = spec.mc > 0 or spec.mci > 0
        # the linear-coupling fusion needs no coupling inequalities: their
        # residuals are needed before the bordered solve that carries u
        self.lin_cc = (self.has_cc and bool(spec.linear_coupling)
                       and spec.mci == 0)
        self.iid = bool(spec.ci_identity) and spec.ni == spec.d
        self.emk, self.imk = spec.ce_mask_key, spec.ci_mask_key
        self.eps = cfg.eps
        self.tiny = float(np.finfo(cfg.np_dtype).tiny)
        self.guard = float(np.sqrt(self.tiny))
        self.nglob = red.size
        self.device = None                    # set by the solver
        me, ni, p = self.me, self.ni, self.p

        def f1(xk, th):
            return torch.reshape(spec.f_blk(xk, th), ())

        self._f_v = vmap(f1)
        self._gradf_v = vmap(grad(f1))
        if me:
            def ce1(xk, th):
                return torch.reshape(spec.ce_blk(xk, th), (me,))
            self._ce_raw = vmap(ce1)
            self._Je_raw = vmap(jacrev(ce1))
        if ni:
            def ci1(xk, th):
                return torch.reshape(spec.ci_blk(xk, th), (ni,))
            self._ci_raw = vmap(ci1)
            self._Ji_raw = vmap(jacrev(ci1))
        if self.has_cc:
            def g1(xk, th):
                return torch.reshape(spec.g_blk(xk, th), (p,))
            self._g_v = vmap(g1)
            self._G_v = vmap(jacrev(g1))

        def lag_blk(xk, th, lek, lik, w):
            # the per-block Lagrangian, coupling contracted through w held
            # constant: its Hessian is the block part W_k (schur.py:292)
            v = f1(xk, th)
            if me:
                v = v - lek @ torch.reshape(spec.ce_blk(xk, th), (me,))
            if ni:
                v = v - lik @ torch.reshape(spec.ci_blk(xk, th), (ni,))
            if self.has_cc:
                v = v - w @ torch.reshape(spec.g_blk(xk, th), (p,))
            return v

        # reverse over reverse: under vmap the vector-Jacobian products of
        # a block's gradient batch into matrix products, where forward over
        # reverse (JAX's ``hessian``) multiplies the block matrix by each
        # tangent apart
        self._W_v = vmap(spec.hess_blk if spec.hess_blk is not None
                         else jacrev(jacrev(lag_blk)),
                         in_dims=(0, 0, 0, 0, None))

    # --- per-block primitives (masked rows are exact zeros) -----------
    def em(self, th):
        return th[self.emk].to(self.dtype)

    def im(self, th):
        return th[self.imk].to(self.dtype)

    def f_v(self, x, th):
        return self._f_v(x, th)

    def gradf_v(self, x, th):
        return self._gradf_v(x, th).to(self.dtype)

    def ce_v(self, x, th):
        v = self._ce_raw(x, th)
        return v * self.em(th) if self.emk else v

    def Je_v(self, x, th):
        J = self._Je_raw(x, th).to(self.dtype)
        return J * self.em(th)[..., None] if self.emk else J

    def ci_v(self, x, th):
        v = self._ci_raw(x, th)
        return v * self.im(th) if self.imk else v

    def Ji_v(self, x, th):
        J = self._Ji_raw(x, th).to(self.dtype)
        return J * self.im(th)[..., None] if self.imk else J

    def g_v(self, x, th):
        return self._g_v(x, th)

    def G_v(self, x, th):
        return self._G_v(x, th).to(self.dtype)

    def W_v(self, x, th, le, li, w):
        return self._W_v(x, th, le, li, w).to(self.dtype)

    def zeros(self, *shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    # --- coupling, residuals, norms (schur.py:335-452) ----------------
    def cc(self, u, ccdata):
        return self.spec.cc(u, ccdata)

    def cci(self, u, ccdata):
        return self.spec.cci(u, ccdata)

    def coupling_state(self, x, th, ccdata, lc, lci, defer_u=False):
        """u (p,) reduced (or, with ``defer_u``, the LOCAL pooled sum for
        a later fused reduction), cc(u), Jcc, cci(u), Jcci and
        w = Jcc^T lc + Jcci^T lci."""
        spec, mc, mci, p = self.spec, self.mc, self.mci, self.p
        if defer_u:
            u = torch.sum(self.g_v(x, th), dim=0)
            u_jac = self.zeros(p)             # affine: Jacobian constant
            cc_val = cci_val = None
        else:
            u = self.red.sum(torch.sum(self.g_v(x, th), dim=0))
            u_jac = u
        if mc:
            Jcc = jacfwd(lambda u_: spec.cc(u_, ccdata))(u_jac).to(self.dtype)
            w = Jcc.T @ lc
            if not defer_u:
                cc_val = spec.cc(u, ccdata)
        else:
            cc_val = None if defer_u else self.zeros(0)
            Jcc = self.zeros(0, p)
            w = self.zeros(p)
        if mci:
            Jcci = jacfwd(lambda u_: spec.cci(u_, ccdata))(u_jac).to(
                self.dtype)
            w = w + Jcci.T @ lci
            if not defer_u:
                cci_val = spec.cci(u, ccdata)
        else:
            if not defer_u:
                cci_val = self.zeros(0)
            Jcci = self.zeros(0, p)
        return u, cc_val, Jcc, cci_val, Jcci, w

    def rx_at(self, x, th, le, li):
        """The gradient of the Lagrangian without its coupling part."""
        rx = self.gradf_v(x, th)
        if self.me:
            rx = rx - torch.einsum("kmd,km->kd", self.Je_v(x, th), le)
        if self.ni:
            if self.iid:
                rx = rx - (li * self.im(th) if self.imk else li)
            else:
                rx = rx - torch.einsum("knd,kn->kd", self.Ji_v(x, th), li)
        return rx

    def rx_coupled_at(self, x, th, ccdata, le, li, lc, lci):
        """The whole gradient of the Lagrangian at ``x`` under the given
        multipliers, its coupling part included (JAX schur.py:773-786):
        one reduction of u(x), none with linear coupling, whose w does
        not depend on u."""
        rx = self.rx_at(x, th, le, li)
        if self.has_cc:
            w = self.coupling_state(x, th, ccdata, lc, lci,
                                    defer_u=self.lin_cc)[5]
            rx = rx - torch.einsum("kpd,p->kd", self.G_v(x, th), w)
        return rx

    def residual_blocks(self, x, s, sc, le, li, lc, lci, th, ccdata, mu,
                        defer_u=False):
        """(rx, rs, rce, rcc, rci, rsc, rcci, (u, Jcc, Jcci, w)); with
        ``defer_u`` rcc is None and u the local pooled sum."""
        Kl = x.shape[0]
        ni, mci = self.ni, self.mci
        rx = self.rx_at(x, th, le, li)
        if ni:
            rs = li - mu / (s + self.guard)
            rci = self.ci_v(x, th) - s
            if self.imk:
                rs = rs * self.im(th)
                rci = rci * self.im(th)
        else:
            rs = self.zeros(Kl, 0)
            rci = self.zeros(Kl, 0)
        rce = self.ce_v(x, th) if self.me else self.zeros(Kl, 0)
        if self.has_cc:
            u, cc_val, Jcc, cci_val, Jcci, w = self.coupling_state(
                x, th, ccdata, lc, lci, defer_u=defer_u)
            rx = rx - torch.einsum("kpd,p->kd", self.G_v(x, th), w)
            rcc = cc_val
        else:
            u = self.zeros(0)
            Jcc = Jcci = self.zeros(0, 0)
            cci_val = w = rcc = self.zeros(0)
        if mci:
            rsc = lci - mu / (sc + self.guard)
            rcci = cci_val - sc
        else:
            rsc = rcci = self.zeros(0)
        return rx, rs, rce, rcc, rci, rsc, rcci, (u, Jcc, Jcci, w)

    def kkt_norms(self, x, s, sc, le, li, lc, lci, th, ccdata, mu,
                  extras=()):
        """Global KKT norms (4,), the four residual sums in ONE reduction
        (with linear coupling the pooled sum rides it too); ``extras``,
        local scalars, ride the same reduction and come back reduced."""
        rx, rs, rce, rcc, rci, rsc, rcci, aux = self.residual_blocks(
            x, s, sc, le, li, lc, lci, th, ccdata, mu, defer_u=self.lin_cc)
        zero = self.zeros()
        parts = [torch.sum(rx ** 2),
                 torch.sum((rs * s) ** 2) if self.ni else zero,
                 torch.sum(rce ** 2) if self.me else zero,
                 torch.sum(rci ** 2) if self.ni else zero]
        stacked = torch.stack(parts + [torch.as_tensor(e, dtype=self.dtype,
                                                       device=self.device)
                                       for e in extras])
        if self.lin_cc:
            red, u_g = self.red.sum_pack(stacked, aux[0])
            rcc = self.cc(u_g, ccdata) if self.mc else self.zeros(0)
            rcci = self.zeros(0)
        else:
            red = self.red.sum(stacked)
        k1 = torch.sqrt(red[0])
        k2 = (torch.sqrt(red[1] + torch.sum((rsc * sc) ** 2))
              if self.has_barrier else zero)
        k3 = (torch.sqrt(red[2] + torch.sum(rcc ** 2))
              if (self.me or self.mc) else zero)
        k4 = (torch.sqrt(red[3] + torch.sum(rcci ** 2))
              if self.has_barrier else zero)
        return torch.stack([k1, k2, k3, k4]), red[4:]

    def fval_g(self, x, th):
        return self.red.sum(torch.sum(self.f_v(x, th)))

    # --- merit (schur.py:454-527) -------------------------------------
    def con_l1_parts(self, x, s, th):
        zero = self.zeros()
        ce_l1 = torch.sum(torch.abs(self.ce_v(x, th))) if self.me else zero
        if self.ni:
            dev = self.ci_v(x, th) - s
            if self.imk:
                dev = dev * self.im(th)
            ci_l1 = torch.sum(torch.abs(dev))
        else:
            ci_l1 = zero
        gsum = (torch.sum(self.g_v(x, th), dim=0) if self.has_cc
                else self.zeros(0))
        return ce_l1, ci_l1, gsum

    def con_l1_from(self, ce_l1, ci_l1, u, sc, ccdata):
        v = ce_l1 + ci_l1
        if self.mc:
            v = v + torch.sum(torch.abs(self.cc(u, ccdata)))
        if self.mci:
            v = v + torch.sum(torch.abs(self.cci(u, ccdata) - sc))
        return v

    def logsum(self, s, th):
        if not self.ni:
            return self.zeros()
        logs = torch.log(s)
        if self.imk:
            logs = logs * self.im(th)        # inactive slacks pinned at 1
        return torch.sum(logs)

    def phi_parts(self, x, s, th):
        ce_l1, ci_l1, gsum = self.con_l1_parts(x, s, th)
        return (torch.sum(self.f_v(x, th)), ce_l1, ci_l1,
                self.logsum(s, th), gsum)

    def phi_from(self, fg, ce_g, ci_g, logg, u, sc, ccdata, mu, nu):
        val = fg + nu * self.con_l1_from(ce_g, ci_g, u, sc, ccdata)
        if self.ni:
            val = val - mu * logg
        if self.mci:
            val = val - mu * torch.sum(torch.log(sc))
        return val

    def phi_many(self, points, th, ccdata, mu, nu):
        """The l1 merit at several points (x, s, sc), every point's local
        parts in ONE reduction; returns [(phi, (ce_l1, ci_l1, u))]."""
        parts = [self.phi_parts(x, s, th) for x, s, _ in points]
        red = self.red.sum_pack(*[v for pt in parts for v in pt])
        out = []
        for i, (_, _, sc) in enumerate(points):
            fg, ce_g, ci_g, logg, u = red[5 * i:5 * i + 5]
            out.append((self.phi_from(fg, ce_g, ci_g, logg, u, sc, ccdata,
                                      mu, nu), (ce_g, ci_g, u)))
        return out

    # --- least-squares multipliers (schur.py:530-769) -----------------
    def _chol(self, A):
        return torch.linalg.cholesky_ex(A)[0]

    @staticmethod
    def _cho_solve(Lc, R):
        """(Kl, k, k) Cholesky factors, (Kl, k) or (Kl, k, r) rhs."""
        if R.dim() == 2:
            return torch.cholesky_solve(R[..., None], Lc)[..., 0]
        return torch.cholesky_solve(R, Lc)

    def ls_multiplier_init(self, x, th, ccdata):
        """The reference's least-squares multipliers lda0 = pinv(J^T)
        grad f (pyipm.py:723-730) through the coupling border: per-block
        SPD solves plus one replicated q x q system, with the Tikhonov
        term of ``lstsq_minnorm`` on the global trace and its guarded
        refinement.  Returns (le, li, lc, lci) before the clamp."""
        Kl = x.shape[0]
        d, me, ni, mc, mci = self.d, self.me, self.ni, self.mc, self.mci
        red, dt = self.red, self.dtype
        q = mc + mci
        nloc = me + ni
        b = self.gradf_v(x, th)
        big_iid = bool(ni and self.iid)
        cols = []
        if me:
            cols.append(self.Je_v(x, th).transpose(1, 2))
        if ni and not self.iid:
            cols.append(self.Ji_v(x, th).transpose(1, 2))
        B = (torch.cat(cols, dim=2) if cols else self.zeros(Kl, d, 0))
        imask = ((self.im(th) if self.imk else self.zeros(Kl, d) + 1)
                 if big_iid else None)
        if self.has_cc:
            _, _, Jcc_, _, Jcci_, _ = self.coupling_state(
                x, th, ccdata, self.zeros(mc), self.zeros(mci))
            Jc = torch.cat([Jcc_, Jcci_], dim=0)           # (q, p)
            C = torch.einsum("kpd,qp->kdq", self.G_v(x, th), Jc)
        else:
            C = self.zeros(Kl, d, 0)
        mtot = self.nglob * Kl * d
        ntot = self.nglob * Kl * nloc + q
        ntot_act = ntot
        if (me and self.emk) or (ni and self.imk):
            e_act = (torch.sum(self.em(th)) if (me and self.emk)
                     else torch.tensor(float(self.nglob * Kl * me),
                                       dtype=dt, device=x.device))
            i_act = (torch.sum(self.im(th)) if (ni and self.imk)
                     else torch.tensor(float(self.nglob * Kl * ni),
                                       dtype=dt, device=x.device))
            ntot_act = q + red.sum(e_act + i_act)
        reg = torch.sqrt(torch.tensor(self.eps, dtype=dt, device=x.device))
        tr = red.sum(torch.sum(B ** 2) + torch.sum(C ** 2)
                     + (torch.sum(imask) if big_iid else self.zeros()))
        eye_q = torch.eye(q, dtype=dt, device=x.device)
        one = self.zeros() + 1

        def sub(a, b_):
            return tuple(u - v for u, v in zip(a, b_))

        def refine(y, apply_G, solve_fn, rhs):
            def gnorm(r_):
                loc, repl = r_
                return torch.sqrt(red.sum(torch.sum(loc ** 2))
                                  + torch.sum(repl ** 2))

            r = sub(rhs, apply_G(y))
            rn = gnorm(r)
            for _ in range(3):
                y1 = tuple(u + v for u, v in zip(y, solve_fn(r)))
                r1 = sub(rhs, apply_G(y1))
                rn1 = gnorm(r1)
                better = rn1 < rn
                y = tuple(torch.where(better, v, u) for u, v in zip(y, y1))
                r = tuple(torch.where(better, v, u) for u, v in zip(r, r1))
                rn = torch.where(better, rn1, rn)
                if not _sync.any_true(better):
                    break
            return y

        def zc_of(yb):
            return (red.sum(torch.einsum("kdq,kd->q", C, yb)) if q
                    else self.zeros(0))

        if mtot <= ntot:
            # underdetermined: lda = J^T (J J^T + reg s I)^-1 b, Woodbury
            # over the coupling columns
            scale = torch.clamp(tr / mtot, min=1.0)
            nb_cols = B.shape[2]
            if big_iid:
                base = imask + reg * scale
                t1 = B / base[..., None]
                if nb_cols:
                    core = (torch.eye(nb_cols, dtype=dt, device=x.device)
                            + torch.einsum("kdm,kdn->kmn", B, t1))
                    che = self._chol(core)

                def dinv(R):                             # (Kl, d, r)
                    t = R / base[..., None]
                    if nb_cols:
                        u = torch.einsum("kdm,kdr->kmr", B, t)
                        t = t - torch.einsum("kdm,kmr->kdr", t1,
                                             self._cho_solve(che, u))
                    return t

                def bbT_mv(yb):
                    out = imask * yb
                    if nb_cols:
                        out = out + torch.einsum(
                            "kdm,km->kd", B,
                            torch.einsum("kdm,kd->km", B, yb))
                    return out
            else:
                Dk = (torch.einsum("kdm,kem->kde", B, B)
                      + (reg * scale) * torch.eye(d, dtype=dt,
                                                  device=x.device))
                ch = self._chol(Dk)

                def dinv(R):
                    return self._cho_solve(ch, R)

                def bbT_mv(yb):
                    return torch.einsum("kdm,km->kd", B,
                                        torch.einsum("kdm,kd->km", B, yb))

            T = dinv(C) if q else None

            def solve_reg(rhs):
                rb, _ = rhs
                y0 = dinv(rb[..., None])[..., 0]
                if q:
                    S = eye_q + red.sum(torch.einsum("kdq,kdr->qr", C, T))
                    zq = torch.linalg.solve(S, zc_of(y0))
                    y0 = y0 - torch.einsum("kdq,q->kd", T, zq)
                return (y0, self.zeros(0))

            def apply_unreg(y):
                yb, _ = y
                out = bbT_mv(yb)
                if q:
                    out = out + torch.einsum("kdq,q->kd", C, zc_of(yb))
                return (out, self.zeros(0))

            rhs = (b, self.zeros(0))
            yb = refine(solve_reg(rhs), apply_unreg, solve_reg, rhs)[0]
            zc = zc_of(yb)
            if big_iid:
                le0 = torch.einsum("kdm,kd->km", B, yb)
                return le0, imask * yb, zc[:mc], zc[mc:]
            lda_blk = torch.einsum("kdm,kd->km", B, yb)
        else:
            # overdetermined: normal equations, Schur complement over the
            # coupling columns
            scale = torch.clamp(tr / ntot_act, min=one)
            Dk = (torch.einsum("kdm,kdn->kmn", B, B)
                  + (reg * scale) * torch.eye(nloc, dtype=dt,
                                              device=x.device))
            BC = torch.einsum("kdm,kdq->kmq", B, C)
            ch = self._chol(Dk)
            T = self._cho_solve(ch, BC) if q else None

            def solve_reg(rhs):
                rb, rq = rhs
                y0 = self._cho_solve(ch, rb)
                if q:
                    S = (red.sum(torch.einsum("kdq,kdr->qr", C, C))
                         + (reg * scale) * eye_q
                         - red.sum(torch.einsum("kmq,kmr->qr", BC, T)))
                    zq = torch.linalg.solve(
                        S, rq - red.sum(torch.einsum("kmq,km->q", BC, y0)))
                    return (y0 - torch.einsum("kmq,q->km", T, zq), zq)
                return (y0, self.zeros(0))

            def apply_unreg(y):
                yk, zq = y
                Byk = torch.einsum("kdm,km->kd", B, yk)
                if q:
                    Byk = Byk + torch.einsum("kdq,q->kd", C, zq)
                out_b = torch.einsum("kdm,kd->km", B, Byk)
                out_q = zc_of(Byk) if q else zq
                return (out_b, out_q)

            rhs = (torch.einsum("kdm,kd->km", B, b), zc_of(b))
            lda_blk, zc = refine(solve_reg(rhs), apply_unreg, solve_reg,
                                 rhs)
        return lda_blk[:, :me], lda_blk[:, me:], zc[:mc], zc[mc:]

    # --- per-block L-BFGS (schur.py:772-891) --------------------------
    def lbfgs_mem_update(self, mem, x, x_old, rx_cur, le, li, lc, lci, th,
                         ccdata, not_first):
        """Every block's curvature pair dx = x - x_old, dg = rx(x) -
        rx(x_old), both ends under the current multipliers, taken into
        its memory where ``not_first`` (0-dim): the very first inner
        iteration keeps the memory (reference pyipm.py:1705)."""
        rx_old = self.rx_coupled_at(x_old, th, ccdata, le, li, lc, lci)
        new = lbfgs_update(
            mem, x - x_old, rx_cur - rx_old,
            constrained=(self.me + self.ni + self.mc + self.mci) > 0,
            eps=self.eps, zeta0=self.cfg.zeta0,
            fail_max=self.cfg.lbfgs_fail_max)
        return LBFGSState(*(torch.where(not_first, a, b)
                            for a, b in zip(new, mem)))

    def lbfgs_prep(self, mem, sig, Ji, Je, th, mu):
        """The condensed block solve from the compact memory: B_k = zeta I
        - W M^-1 W^T (the middle matrix of core/lbfgs.py), A_k = B_k +
        Ji^T Sigma Ji by Sherman-Morrison-Woodbury over a diagonal base,
        the equality rows by a per-block (me x me) Schur complement.
        Returns (solve_blk, hess_mv, eq_app)."""
        d, me, ni, dt = self.d, self.me, self.ni, self.dtype
        Kl = mem.S.shape[0]
        zeta = mem.zeta
        Sm, Ym, SS, Lm, Dv, valid = _masked_mem(mem, True)
        Mmid = _padded_middle(SS, Lm, Dv, valid, zeta)
        Wlb = torch.cat([zeta[:, None, None] * Sm, Ym], dim=2)
        m2 = Wlb.shape[2]
        # Mmid and the core below are indefinite: LU, not Cholesky
        Mlu, Mpiv, _ = torch.linalg.lu_factor_ex(Mmid)

        def hess_mv(dx_):                                # B dx
            t = torch.einsum("kdm,kd->km", Wlb, dx_)
            v = torch.linalg.lu_solve(Mlu, Mpiv, t[..., None])[..., 0]
            return zeta[:, None] * dx_ - torch.einsum("kdm,km->kd", Wlb, v)

        # A = diag(D0) + V Lam V^T with Lam = blockdiag(-M^-1, I)
        if ni and self.iid:
            D0 = zeta[:, None] + sig                     # Sigma folded
            V, Lam_inv = Wlb, -Mmid
        elif ni:
            D0 = zeta[:, None].expand(Kl, d)
            V = torch.cat([Wlb, Ji.transpose(1, 2)
                           * torch.sqrt(sig)[:, None, :]], dim=2)
            Lam_inv = self.zeros(Kl, m2 + ni, m2 + ni)
            Lam_inv[:, :m2, :m2] = -Mmid
            Lam_inv[:, m2:, m2:] = torch.eye(ni, dtype=dt,
                                             device=Mmid.device)
        else:
            D0 = zeta[:, None].expand(Kl, d)
            V, Lam_inv = Wlb, -Mmid
        core = Lam_inv + torch.einsum("kdp,kd,kdq->kpq", V, 1.0 / D0, V)
        Clu, Cpiv, _ = torch.linalg.lu_factor_ex(core)

        def a_inv(R):                                    # (Kl, d, r)
            t = R / D0[..., None]
            v = torch.linalg.lu_solve(Clu, Cpiv,
                                      torch.einsum("kdp,kdr->kpr", V, t))
            return t - torch.einsum("kdp,kpr->kdr", V, v) / D0[..., None]

        if not me:
            return a_inv, hess_mv, self.zeros(Kl)
        T = a_inv(Je.transpose(1, 2))                    # (Kl, d, me)
        Se = torch.einsum("kmd,kdn->kmn", Je, T)
        ev = torch.abs(torch.linalg.eigvalsh(Se))
        rcond = (torch.amin(ev, dim=-1)
                 / torch.clamp(torch.amax(ev, dim=-1), min=self.tiny))
        finite = torch.all(torch.isfinite(ev), dim=-1)
        reg = _eq_reg_term(mu, self.cfg.reg_coef, self.cfg.eta,
                           self.cfg.beta)
        eq_app = torch.where((rcond <= self.eps) | ~finite, reg,
                             self.zeros(Kl))
        Se = Se + eq_app[:, None, None] * torch.eye(me, dtype=dt,
                                                    device=Se.device)
        if self.emk:
            # identity-pin inactive (masked) equality rows
            Se = Se + torch.diag_embed(1.0 - self.em(th))
        ch = self._chol(Se)

        def solve_blk(rhs):                              # (Kl, n, r)
            t = a_inv(rhs[:, :d, :])
            y = self._cho_solve(
                ch, torch.einsum("kmd,kdr->kmr", Je, t) - rhs[:, d:, :])
            return torch.cat([t - torch.einsum("kdm,kmr->kdr", T, y), y],
                             dim=1)

        return solve_blk, hess_mv, eq_app

    # --- the exact-Hessian block solve (schur.py:964-1001) -------------
    def exact_block_solve(self, x, th, le, li, w, sig, Ji, Je, delta, mu):
        """Every block's condensed (d + me)^2 matrix from its Lagrangian
        Hessian, factored with inertia correction.  Returns (solve_blk,
        hess_mv, delta_new, retries, eq_app)."""
        cfg, d, me, ni, n = self.cfg, self.d, self.me, self.ni, self.n
        W = self.W_v(x, th, le, li, w)
        if ni and self.iid:
            A = W.clone()
            A.diagonal(dim1=1, dim2=2).add_(sig)
        elif ni:
            A = W + torch.einsum("kdn,kn,kne->kde", Ji.transpose(1, 2),
                                 sig, Ji)
        else:
            A = W
        if me:
            M = self.zeros(x.shape[0], n, n)
            M[:, :d, :d] = A
            M[:, :d, d:] = Je.transpose(1, 2)
            M[:, d:, :d] = Je
            if self.emk:
                # identity-pin inactive equality rows (diagonal -1 keeps
                # the inertia target at me negative pivots)
                M[:, d:, d:].diagonal(dim1=1, dim2=2).add_(self.em(th) - 1.0)
        else:
            M = A
        M = (M + M.transpose(1, 2)) * 0.5
        del A
        solve_blk, delta_new, retries, (delta_app, eq_app) = \
            batched_reg_factor(
                M, delta, mu, neq=me, eps=self.eps, reg_coef=cfg.reg_coef,
                eta=cfg.eta, beta=cfg.beta, delta0=cfg.delta0,
                max_retries=cfg.max_reg_retries, block=cfg.ldlt_block)
        del M

        def hess_mv(dx_):
            return (torch.einsum("kde,ke->kd", W, dx_)
                    + delta_app[:, None] * dx_)

        return solve_blk, hess_mv, delta_new, retries, eq_app

    # --- the direction (schur.py:892-1377) ----------------------------
    def direction(self, x, s, sc, le, li, lc, lci, th, ccdata, mu, delta,
                  lbfgs=None, x_old=None, not_first=None):
        """The condensed Newton step through the coupling border.

        Returns (steps, pending, resolve, delta_new, retries, mu_new,
        lbfgs_new): ``steps`` = (dx, ds, dsc, dae, db, dbc, dac) with the
        pre-flip multiplier signs of ops/condensed.py; ``pending`` the
        refinement guard's last candidate, decided on the caller's fused
        reduction (or None); ``resolve`` the same-matrix SOC solve.  In
        L-BFGS mode the memory ``lbfgs`` takes the pair from ``x_old``
        where ``not_first`` and the block solve is its Woodbury operator;
        ``lbfgs_new`` is the updated memory (None in exact-Hessian
        mode)."""
        cfg, red, spec = self.cfg, self.red, self.spec
        d, me, ni, p, mc, mci, n = (self.d, self.me, self.ni, self.p,
                                    self.mc, self.mci, self.n)
        Kl = x.shape[0]
        dt, dev = self.dtype, x.device
        guard, iid, imk, emk = self.guard, self.iid, self.imk, self.emk
        has_cc, lin_cc = self.has_cc, self.lin_cc
        rx, rs, rce, rcc, rci, rsc, rcci, (u, Jcc, Jcci, w) = \
            self.residual_blocks(x, s, sc, le, li, lc, lci, th, ccdata, mu,
                                 defer_u=lin_cc)
        g1, g2, g3e, g4 = -rx, -rs, -rce, -rci
        if lin_cc:
            # u is the LOCAL pooled sum: it rides the first bordered
            # solve's reduction, and the coupling rhs is built after it
            gsum_dir = u
            g3c = ((lambda u_: -self.cc(u_, ccdata)) if mc
                   else self.zeros(0))
        else:
            gsum_dir = None
            g3c = -rcc
        g2c, g4c = -rsc, -rcci
        sigc = lci / (sc + guard) if mci else self.zeros(0)

        Ji = Je = None                  # never built on the identity path
        if ni:
            sig = li / (s + guard)
            if iid and imk:
                sig = sig * self.im(th)
            if not iid:
                Ji = self.Ji_v(x, th)
                JiT = Ji.transpose(1, 2)
        else:
            sig = self.zeros(Kl, 0)

        def ji_mv(v):
            if iid:
                return v * self.im(th) if imk else v
            return torch.einsum("knd,kd->kn", Ji, v)

        def jiT_mv(v):
            if iid:
                return v * self.im(th) if imk else v
            return torch.einsum("kdn,kn->kd", JiT, v)

        if me:
            Je = self.Je_v(x, th)

        if cfg.lbfgs:
            # the compact per-block operator: no W, no M, no d^3 factor;
            # B is positive definite by the curvature guard, so there are
            # no inertia retries and no shift
            lbfgs_new = self.lbfgs_mem_update(lbfgs, x, x_old, rx, le, li,
                                              lc, lci, th, ccdata,
                                              not_first)
            solve_blk, hess_mv, eq_app = self.lbfgs_prep(lbfgs_new, sig, Ji,
                                                         Je, th, mu)
            delta_new, retries = delta, 0
        else:
            lbfgs_new = None
            solve_blk, hess_mv, delta_new, retries, eq_app = \
                self.exact_block_solve(x, th, le, li, w, sig, Ji, Je, delta,
                                       mu)

        border = {}          # linear coupling: filled at the first solve
        if has_cc:
            G = self.G_v(x, th)

            def lag_u(u_):
                t = self.zeros()
                if mc:
                    t = t + lc @ self.cc(u_, ccdata)
                if mci:
                    t = t + lci @ self.cci(u_, ccdata)
                return t

            Hu = (self.zeros(p, p) if lin_cc
                  else hessian(lag_u)(u).to(dt))
            Hhat = (Hu - (Jcci.T * sigc[None, :]) @ Jcci) if mci else Hu
            Ghat = self.zeros(Kl, n, p)
            Ghat[:, :d, :] = G.transpose(1, 2)
            X = solve_blk(Ghat)

            def build_border(Pm_):
                Bm = self.zeros(p + mc, p + mc)
                Bm[:p, :p] = torch.eye(p, dtype=dt, device=dev) - Pm_ @ Hhat
                if mc:
                    Bm[:p, p:] = Pm_ @ Jcc.T
                    Bm[p:, :p] = Jcc
                    # Tikhonov on the zero block; refinement corrects
                    Bm[p:, p:] = cfg.reg_coef * torch.eye(mc, dtype=dt,
                                                          device=dev)
                return torch.linalg.lu_factor(Bm)

            Pm_loc = torch.einsum("kpd,kdq->pq", G, X[:, :d, :])
            if not lin_cc:
                border["Pm"] = red.sum(Pm_loc)
                border["blu"] = build_border(border["Pm"])

        def solve_full_multi(rhs0s, g3cs, extras=()):
            """Bordered solves of R block rhs (Kl, n) at once; ``extras``
            (local scalars) ride the border reduction.  Returns ([(U, dac,
            v, vv)], reduced extras); vv = the reduced G U[:, :d],
            computed analytically as pv + Pm y."""
            U0s = solve_blk(torch.stack(rhs0s, dim=-1))
            if not has_cc:
                red_ex = red.sum_pack(*extras) if extras else []
                z0 = self.zeros(0)
                return ([(U0s[..., r], z0, z0, z0)
                         for r in range(len(rhs0s))], red_ex)
            pv_loc = torch.einsum("kpd,kdr->pr", G, U0s[:, :d, :])
            if lin_cc and "blu" not in border:
                # the first bordered solve: the pooled sum and the border
                # ride the pv reduction (3 all-reduces become 1)
                packed = red.sum_pack(pv_loc, Pm_loc, gsum_dir, *extras)
                pv, red_ex = packed[0], packed[3:]
                border["Pm"], border["u"] = packed[1], packed[2]
                border["blu"] = build_border(packed[1])
            else:
                packed = red.sum_pack(pv_loc, *extras)
                pv, red_ex = packed[0], packed[1:]
            LU, piv = border["blu"]
            outs = []
            for r, g3c_r in enumerate(g3cs):
                if callable(g3c_r):
                    g3c_r = g3c_r(border["u"])
                vdac = torch.linalg.lu_solve(
                    LU, piv, torch.cat([pv[:, r], g3c_r])[:, None])[:, 0]
                v, dac = vdac[:p], vdac[p:]
                y = Hhat @ v - (Jcc.T @ dac if mc else 0.0)
                U = U0s[..., r] + torch.einsum("knp,p->kn", X, y)
                outs.append((U, dac, v, pv[:, r] + border["Pm"] @ y))
            return outs, red_ex

        def solve_full(rhs0_, g3c_, extras=()):
            outs, red_ex = solve_full_multi([rhs0_], [g3c_], extras)
            return outs[0] + (red_ex,)

        def recover(U, dac, v, g2_, g4_, g2c_, g4c_):
            dx = U[:, :d]
            dae = U[:, d:]
            if ni:
                ds = ji_mv(dx) - g4_
                db = sig * ds - g2_
            else:
                ds = db = self.zeros(Kl, 0)
            if mci:
                dsc = Jcci @ v - g4c_
                dbc = sigc * dsc - g2c_
            else:
                dsc = dbc = self.zeros(0)
            return dx, ds, dsc, dae, db, dbc, dac

        def g3c_now():
            return g3c(border["u"]) if callable(g3c) else g3c

        def full_residual(dx, ds, dsc, dae, db, dbc, dac, g2_, g2c_, vv):
            """Residual of the regularized full Newton system by block
            products, collective-free (vv comes back from the border)."""
            r1 = g1 - hess_mv(dx)
            if me:
                r1 = r1 - torch.einsum("kmd,km->kd", Je, dae)
                row = (torch.einsum("kmd,kd->km", Je, dx)
                       - eq_app[:, None] * dae)
                if emk:
                    row = row + (self.em(th) - 1.0) * dae
                r3e = g3e - row
            else:
                r3e = g3e
            if ni:
                r1 = r1 - jiT_mv(db)
                r2 = g2_ - (sig * ds - db)
                r4 = g4 - (ji_mv(dx) - ds)
            else:
                r2, r4 = g2_, g4
            if has_cc:
                wrow = -Hu @ vv
                if mc:
                    wrow = wrow + Jcc.T @ dac
                if mci:
                    wrow = wrow + Jcci.T @ dbc
                r1 = r1 - torch.einsum("kpd,p->kd", G, wrow)
                g3c_a = g3c_now()
                r3c = g3c_a - (Jcc @ vv if mc else g3c_a * 0)
                if mci:
                    r2c = g2c_ - (sigc * dsc - dbc)
                    r4c = g4c - (Jcci @ vv - dsc)
                else:
                    r2c, r4c = g2c_, g4c
            else:
                r3c, r2c, r4c = g3c, g2c_, g4c
            return r1, r2, r3e, r3c, r4, r2c, r4c

        def norm2_parts(r):
            r1, r2, r3e, r3c, r4, r2c, r4c = r
            loc = (torch.sum(r1 ** 2) + torch.sum(r2 ** 2)
                   + torch.sum(r3e ** 2) + torch.sum(r4 ** 2))
            rep = (torch.sum(r3c ** 2) + torch.sum(r2c ** 2)
                   + torch.sum(r4c ** 2))
            return loc, rep

        def ineq_coupling_pull(r2c_, r4c_):
            return torch.einsum("kpd,p->kd", G,
                                Jcci.T @ (sigc * r4c_ + r2c_))

        def condensed_rhs(r):
            r1, r2, r3e, r3c, r4, r2c, r4c = r
            rr1 = r1 + (jiT_mv(sig * r4 + r2) if ni else 0.0)
            if mci:
                rr1 = rr1 + ineq_coupling_pull(r2c, r4c)
            return (torch.cat([rr1, r3e], dim=1) if me else rr1), r3c

        def condensed_apply_multi(rs_, extras=()):
            rhs = [condensed_rhs(r) for r in rs_]
            outs, red_ex = solve_full_multi([a for a, _ in rhs],
                                            [b_ for _, b_ in rhs], extras)
            res = []
            for r, (Ue, eac, ev, vvc) in zip(rs_, outs):
                _, r2, _, _, r4, r2c, r4c = r
                res.append((recover(Ue, eac, ev, r2, r4, r2c, r4c), vvc))
            return res, red_ex

        def assemble_rhs0(g2_, g2c_):
            rr1 = g1 + jiT_mv(sig * g4 + g2_) if ni else g1
            if mci:
                rr1 = rr1 + ineq_coupling_pull(g2c_, g4c)
            return torch.cat([rr1, g3e], dim=1) if me else rr1

        def where(c, a, b_):
            return tuple(torch.where(c, u_, v_) for u_, v_ in zip(a, b_))

        def solve_refined(g2_, g2c_, defer_final_guard=False):
            """Bordered solve and guarded refinement (one reduction a
            step; the last guard decision deferred to the caller's fused
            reduction with ``defer_final_guard``)."""
            U, dac_, v, vv, _ = solve_full(assemble_rhs0(g2_, g2c_), g3c)
            steps = recover(U, dac_, v, g2_, g4, g2c_, g4c)
            nsteps = max(int(cfg.schur_refine_steps), 0)
            if nsteps == 0:
                return (steps, None) if defer_final_guard else steps
            if not cfg.schur_refine_guard:
                for _ in range(nsteps):
                    r = full_residual(*steps, g2_, g2c_, vv)
                    (corr, vvc), = condensed_apply_multi([r])[0]
                    steps = tuple(a + b_ for a, b_ in zip(steps, corr))
                    vv = vv + vvc
                return (steps, None) if defer_final_guard else steps
            steps_acc, vv_acc = steps, vv
            r_acc = full_residual(*steps_acc, g2_, g2c_, vv_acc)
            loc_acc, rep_acc = norm2_parts(r_acc)
            cand = None
            for _ in range(nsteps):
                if cand is None:
                    out, red_ex = condensed_apply_multi([r_acc],
                                                        extras=(loc_acc,))
                    (corr, vvc), = out
                    rn_acc = red_ex[0] + rep_acc
                else:
                    # the pending candidate decided on this solve's
                    # reduction; both outcomes' corrections are two rhs
                    # columns of one bordered solve
                    sC, vC, rC, locC, repC = cand
                    out, red_ex = condensed_apply_multi([rC, r_acc],
                                                        extras=(locC,))
                    (corrA, vvA), (corrB, vvB) = out
                    rnC = red_ex[0] + repC
                    better = rnC < rn_acc
                    steps_acc = where(better, sC, steps_acc)
                    vv_acc = torch.where(better, vC, vv_acc)
                    r_acc = where(better, rC, r_acc)
                    rn_acc = torch.minimum(rnC, rn_acc)
                    corr = where(better, corrA, corrB)
                    vvc = torch.where(better, vvA, vvB)
                new_steps = tuple(a + b_ for a, b_ in zip(steps_acc, corr))
                new_vv = vv_acc + vvc
                new_r = full_residual(*new_steps, g2_, g2c_, new_vv)
                cand = (new_steps, new_vv, new_r, *norm2_parts(new_r))
            sC, vC, rC, locC, repC = cand
            if defer_final_guard:
                return steps_acc, (sC, locC, repC, rn_acc)
            better = (red.sum(locC) + repC) < rn_acc
            return where(better, sC, steps_acc)

        if cfg.mu_strategy == "mehrotra" and self.has_barrier:
            # predictor-corrector through the same factors and border
            one = self.zeros() + 1
            msk = self.im(th) if (ni and imk) else None
            g2_aff = -(li * msk) if msk is not None else -li
            g2c_aff = -lci
            dx_a, ds_a, dsc_a, dae_a, db_a, dbc_a, dac_a = solve_refined(
                g2_aff, g2c_aff)
            dli_a, dlci_a = -db_a, -dbc_a
            if ni:
                a_sl = red.min(torch.stack([_ftb(s, ds_a, 1.0),
                                            _ftb(li, dli_a, 1.0)]))
                a_s, a_l = a_sl[0], a_sl[1]
            else:
                a_s = a_l = one
            if mci:
                a_s = torch.minimum(a_s, _ftb(sc, dsc_a, 1.0))
                a_l = torch.minimum(a_l, _ftb(lci, dlci_a, 1.0))
            if msk is not None:
                sl_g, aff_g, cnt_g = red.sum_pack(
                    torch.sum(msk * s * li),
                    torch.sum(msk * ((s + a_s * ds_a) * (li + a_l * dli_a))),
                    torch.sum(msk))
                ntot_g = cnt_g + mci
            else:
                sl_g, aff_g = red.sum_pack(
                    torch.sum(s * li),
                    torch.sum((s + a_s * ds_a) * (li + a_l * dli_a)))
                ntot_g = float(self.nglob * s.numel() + mci)
            mu_mean = (sl_g + torch.sum(sc * lci)) / ntot_g
            mu_aff = (aff_g + torch.sum((sc + a_s * dsc_a)
                                        * (lci + a_l * dlci_a))) / ntot_g
            sigma_c = torch.clamp((mu_aff / (mu_mean + guard)) ** 3, 0.0, 1.0)
            mu_new = torch.clamp(sigma_c * mu_mean, min=cfg.mu_floor)
            corr = (mu_new - ds_a * dli_a) / (s + guard)
            g2_m = g2_aff + (corr * msk if msk is not None else corr)
            g2c_m = (g2c_aff + (mu_new - dsc_a * dlci_a) / (sc + guard)
                     if mci else g2c_aff)
            steps, pending = solve_refined(g2_m, g2c_m,
                                           defer_final_guard=True)
        else:
            mu_new = mu
            steps, pending = solve_refined(g2, g2c, defer_final_guard=True)

        def resolve(rce_n, rcc_n, rci_n, rcci_n):
            """Same-matrix SOC: constraint-only residuals through the
            same factors (zero gradient rows)."""
            g4n, g4cn = -rci_n, -rcci_n
            rr1 = jiT_mv(sig * g4n) if ni else self.zeros(Kl, d)
            if mci:
                rr1 = rr1 + ineq_coupling_pull(self.zeros(mci), g4cn)
            rr0 = torch.cat([rr1, -rce_n], dim=1) if me else rr1
            Up, _, vp, _, _ = solve_full(rr0, -rcc_n)
            dx_p = Up[:, :d]
            ds_p = ji_mv(dx_p) - g4n if ni else self.zeros(Kl, 0)
            dsc_p = Jcci @ vp - g4cn if mci else self.zeros(0)
            return dx_p, ds_p, dsc_p

        return (steps, pending, resolve, delta_new, retries, mu_new,
                lbfgs_new)


def _ftb(z, dz, tau):
    """Fraction-to-the-boundary step of a whole slab (0-dim)."""
    return max_step_ftb(z.reshape(1, -1), dz.reshape(1, -1), tau)[0]


def _one(v):
    """A 0-dim value as the (1,) field of a batch-of-one state."""
    return torch.reshape(v, (1,))


# ----------------------------------------------------------------------
class BlockSolver(LoopEngine):
    """The block-separable solver of one (spec, config) on this rank's
    blocks; see :func:`make_block_solver`."""

    lazy_epilogue = True           # the epilogue's pmin: only when taken
    echo = False

    def __init__(self, spec: BlockNLP, mesh=None,
                 config: Optional[IPMConfig] = None, axis: str = "model",
                 device=None):
        cfg = config if config is not None else IPMConfig(
            float_dtype="float32")
        cfg = cfg.resolve_mu_strategy(spec.ni + spec.mci)
        if cfg.verbosity > 0:
            # progress lines would interleave across ranks; the result
            # reports signal, kkt and iter_count (JAX schur.py:223-227)
            cfg = cfg.replace(verbosity=0)
        self.spec, self.config, self.mesh, self.axis = spec, cfg, mesh, axis
        self.device = resolve_device(device)
        self.reducer = Reducer(None if mesh is None else mesh.get_group(axis))
        self.ops = _Ops(spec, cfg, self.reducer)
        self.ops.device = self.device
        self.has_ineq = self.ops.has_barrier
        self.unconstrained = (spec.me + spec.ni + spec.mc + spec.mci) == 0

    # --- data ---------------------------------------------------------
    def _to(self, t):
        t = torch.as_tensor(t, device=self.device)
        return t.to(self.config.torch_dtype) if t.is_floating_point() else t

    def local_data(self, theta, ccdata=None):
        """(this rank's rows of every theta tensor, ccdata), on the
        solver's device, floating tensors in its dtype; theta and ccdata
        are (nested) dicts of tensors."""
        def conv(tree, sl=None):
            if isinstance(tree, dict):
                return {k: conv(v, sl) for k, v in tree.items()}
            t = self._to(tree)
            return t if sl is None else t[sl]

        def rows(tree):
            if isinstance(tree, dict):
                for v in tree.values():
                    r = rows(v)
                    if r is not None:
                        return r
                return None
            return len(tree)

        K = rows(theta)
        th = conv(dict(theta), None if K is None else self._slice(K))
        cc = conv(dict(ccdata)) if ccdata is not None else {}
        return th, cc

    def _slice(self, K: int) -> slice:
        n, r = self.reducer.size, self.reducer.rank
        if K % n:
            raise ValueError(f"K = {K} blocks do not split over {n} ranks")
        per = K // n
        return slice(r * per, (r + 1) * per)

    # --- the loop engine's hooks --------------------------------------
    def take(self, st, ids, p):
        return st, p

    def put(self, st, ids, sub):
        return sub

    def f_val(self, st, p):
        return _one(self.ops.fval_g(st.x, p[0]))

    def history_row(self, sub):
        dmax = self.reducer.max(torch.amax(sub.delta)) if sub.delta.numel() \
            else sub.delta.new_zeros(())
        return MetricsHistory(sub.kkt, sub.mu, sub.nu, sub.alpha, _one(dmax))

    def centrality_stats(self, st, p):
        """Only the pair minimum pays a reduction (one min); the pair sum
        and count rode the last KKT reduction into ``st.g`` (JAX
        schur.py:1694-1727)."""
        ops, th = self.ops, p[0]
        _, li, _, lci = st.lda
        s, sc = st.s
        msk = ops.im(th) if (ops.ni and ops.imk) else None
        if ops.ni:
            pairs = msk * s * li if msk is not None else s * li
            pin = (torch.where(msk > 0, pairs, torch.full_like(pairs,
                                                               float("inf")))
                   if msk is not None else pairs)
            smin = self.reducer.min(torch.amin(pin))
            if ops.mci:
                smin = torch.minimum(smin, torch.amin(sc * lci))
        else:
            smin = torch.amin(sc * lci)
        sl, ntot = st.g[:, 0], st.g[:, 1]
        if msk is not None:
            ntot = torch.clamp(ntot, min=1)
        smin = torch.where(torch.isfinite(smin), smin, torch.zeros_like(smin))
        return sl, _one(smin), ntot

    def inner_iter(self, st: SolverState, p) -> SolverState:
        """One primal-dual iteration (JAX schur.py:1382-1690): the
        direction, one fused reduction of everything that follows it, the
        global fraction-to-the-boundary, the merit line search with the
        same-matrix SOC, and the KKT norms with the post-step lanes."""
        ops, cfg, red = self.ops, self.config, self.reducer
        th, ccdata = p
        ni, mci, has_cc = ops.ni, ops.mci, ops.has_cc
        guard, eps, tiny = ops.guard, ops.eps, ops.tiny
        le, li, lc, lci = st.lda
        s_blk, sc = st.s
        x = st.x
        mu, nu0 = st.mu[0], st.nu[0]
        dev = x.device
        not_first = ((st.outer > 0) | (st.inner > 0))[0]
        with profiling.annotate("ipm-direction", dev):
            (steps_main, pending, resolve, delta_new, retries, mu_new,
             lbfgs_new) = ops.direction(
                 x, s_blk, sc, le, li, lc, lci, th, ccdata, mu, st.delta,
                 lbfgs=st.lbfgs, x_old=st.x_old, not_first=not_first)
        if cfg.lbfgs:
            # the memory moved inside the direction, before the line
            # search: a rejected step keeps it (JAX schur.py:1393-1400)
            st = st._replace(lbfgs=lbfgs_new,
                             x_old=torch.where(not_first, x, st.x_old))

        # the post-direction reductions, fused: the retry count, the merit
        # penalty's l1 parts, the pooled features, the merit entry value's
        # ingredients, the step-norm parts, the dphi products and the
        # deferred refinement guard (schur.py:1401-1449)
        ce_l1, ci_l1, gsum = ops.con_l1_parts(x, s_blk, th)
        floc = torch.sum(ops.f_v(x, th))
        logloc = ops.logsum(s_blk, th)
        gradf = ops.gradf_v(x, th)

        def dir_lanes(stp):
            dx_, ds_ = stp[0], stp[1]
            return (torch.sum(gradf * dx_),
                    (torch.sum(-mu_new / (s_blk + guard) * ds_) if ni
                     else ops.zeros()),
                    torch.sum(dx_ ** 2),
                    torch.sum(ds_ ** 2) if ni else ops.zeros())

        retr = ops.zeros() + float(retries)
        fixed = (retr, ce_l1, ci_l1, floc, logloc, gsum)
        lanesA = dir_lanes(steps_main)
        if pending is not None:
            sC, locC, repC, rn_acc = pending
            packed = red.sum_pack(*fixed, *lanesA, *dir_lanes(sC), locC)
            better = (packed[14] + repC) < rn_acc
            steps = tuple(torch.where(better, a, b)
                          for a, b in zip(sC, steps_main))
            gdot_g, bds_g, sdx2_g, sds2_g = (
                torch.where(better, b, a)
                for a, b in zip(packed[6:10], packed[10:14]))
        else:
            packed = red.sum_pack(*fixed, *lanesA)
            steps = steps_main
            gdot_g, bds_g, sdx2_g, sds2_g = packed[6:10]
        retr_g, ce_g, ci_g, f_g, log_g, u_g = packed[:6]
        dx, ds, dsc, dae, db, dbc, dac = steps
        # multiplier sign flip (pyipm.py:1723-1725)
        dle, dli, dlc, dlci = -dae, -db, -dac, -dbc
        st = st._replace(mu=_one(mu_new), delta=delta_new,
                         reg_retries=st.reg_retries
                         + retr_g.to(torch.int32))
        mu = mu_new
        cl1 = ops.con_l1_from(ce_g, ci_g, u_g, sc, ccdata)
        bdot = gdot_g + bds_g
        if mci:
            bdot = bdot + torch.sum(-mu / (sc + guard) * dsc)
        nu = torch.maximum(nu0, nu_threshold(bdot, cl1, cfg.rho, tiny))

        # global fraction-to-the-boundary, both minima in one reduction
        one = ops.zeros() + 1
        if ni:
            a_sl = red.min(torch.stack([_ftb(s_blk, ds, cfg.tau),
                                        _ftb(li, dli, cfg.tau)]))
            a_s, a_l = a_sl[0], a_sl[1]
        else:
            a_s = a_l = one
        if mci:
            a_s = torch.minimum(a_s, _ftb(sc, dsc, cfg.tau))
            a_l = torch.minimum(a_l, _ftb(lci, dlci, cfg.tau))

        phi0 = ops.phi_from(f_g, ce_g, ci_g, log_g, u_g, sc, ccdata, mu, nu)
        dphi0 = bdot - nu * cl1
        slack = 10.0 * eps * (1.0 + torch.abs(phi0))
        eta = cfg.eta

        def armijo_rhs(ids, a):
            return phi0 + a * eta * dphi0 + slack

        entry = []                    # the entry trial's reduced l1 parts

        def phi_at(ids, a):
            """Merit at x + a dx, a (1,) or (1, W): every trial's parts in
            ONE reduction."""
            ts = a.reshape(-1)
            out = ops.phi_many([(x + t * dx, s_blk + t * ds, sc + t * dsc)
                                for t in ts], th, ccdata, mu, nu)
            if not entry:
                entry.append(out[0][1])
            return torch.stack([v for v, _ in out]).reshape(a.shape)

        # a_s, a_l are replicated: the step norm from the reduced lanes
        base = torch.sqrt(a_s ** 2 * sdx2_g + a_l ** 2 * sds2_g
                          + torch.sum((a_l * dsc) ** 2))

        def base_of(ids):
            return _one(base)

        payload_zero = (torch.zeros_like(dx)[None],
                        torch.zeros_like(ds)[None],
                        torch.zeros_like(dsc)[None], _one(one))

        def try_soc(ids):
            """Second-order correction where infeasibility went up
            (pyipm.py:1464-1489), through the same factors: the test and
            the pooled features come from the entry trial's reduction, the
            two acceptance merits share one."""
            xa, sa, sca = x + a_s * dx, s_blk + a_s * ds, sc + a_s * dsc
            ce_ga, ci_ga, u_ga = entry[0]
            new_l1 = ops.con_l1_from(ce_ga, ci_ga, u_ga, sca, ccdata)
            no = torch.zeros((1,), dtype=torch.bool, device=dev)
            if not _sync.any_true(new_l1 > cl1):
                return no, payload_zero
            Kl = xa.shape[0]
            rce_n = ops.ce_v(xa, th) if ops.me else ops.zeros(Kl, 0)
            if ni:
                rci_n = ops.ci_v(xa, th) - sa
                if ops.imk:
                    rci_n = rci_n * ops.im(th)
            else:
                rci_n = ops.zeros(Kl, 0)
            if has_cc:
                rcc_n = ops.cc(u_ga, ccdata) if ops.mc else ops.zeros(0)
                rcci_n = (ops.cci(u_ga, ccdata) - sca if mci
                          else ops.zeros(0))
            else:
                rcc_n = rcci_n = ops.zeros(0)
            dx_p, ds_p, dsc_p = resolve(rce_n, rcc_n, rci_n, rcci_n)
            rhs = armijo_rhs(ids, a_s)
            if ops.has_barrier:
                a_corr = one
                if ni:
                    a_corr = red.min(_ftb(s_blk, a_s * ds + ds_p, cfg.tau))
                if mci:
                    a_corr = torch.minimum(a_corr, _ftb(
                        sc, a_s * dsc + dsc_p, cfg.tau))
                (phi1, _), (phi2, _) = ops.phi_many(
                    [(xa + dx_p, sa + ds_p, sca + dsc_p),
                     (x + a_corr * (a_s * dx + dx_p),
                      s_blk + a_corr * (a_s * ds + ds_p),
                      sc + a_corr * (a_s * dsc + dsc_p))],
                    th, ccdata, mu, nu)
                ok = (phi1 <= rhs) & (phi2 <= rhs)
            else:
                ok = ops.phi_many([(xa + dx_p, sa + ds_p, sca + dsc_p)],
                                  th, ccdata, mu, nu)[0][0] <= rhs
                a_corr = one
            return (_one(ok), (dx_p[None], ds_p[None], dsc_p[None],
                               _one(a_corr)))

        with profiling.annotate("ipm-line-search", dev):
            a_sf, a_lf, soc, aborted, payload = merit_line_search(
                phi_at, armijo_rhs, base_of, _one(a_s), _one(a_l), try_soc,
                payload_zero, tau=cfg.tau, eps=eps,
                chunk=cfg.backtrack_chunk, max_backtrack=cfg.max_backtrack)
        a_sf, a_lf, soc, aborted = a_sf[0], a_lf[0], soc[0], aborted[0]
        dx_p, ds_p, dsc_p, a_corr = (t[0] for t in payload)
        corr = torch.where(soc, a_corr, one)
        gate = torch.where(soc, one, ops.zeros())

        def keep(new, old):
            return torch.where(aborted, old, new)

        x_n = keep(x + corr * (a_sf * dx + gate * dx_p), x)
        s_n = keep(s_blk + corr * (a_sf * ds + gate * ds_p), s_blk) if ni \
            else s_blk
        sc_n = keep(sc + corr * (a_sf * dsc + gate * dsc_p), sc) if mci \
            else sc
        lda = tuple(keep(v + a_lf * dv, v) for v, dv in
                    ((le, dle), (li, dli), (lc, dlc), (lci, dlci)))
        st = st._replace(
            x=x_n, s=(s_n, sc_n), lda=lda, nu=_one(nu),
            alpha=_one(torch.where(aborted, ops.zeros(), a_sf)),
            signal=torch.where(aborted, torch.full_like(st.signal, -2),
                               st.signal),
            iter_count=st.iter_count + 1)
        len_, lin_, lcn_, lcin_ = lda

        # post-step lanes on the KKT reduction: the non-finite count,
        # the objective (eq-only Ftol), the centrality sum and count
        extras = []
        if cfg.nan_guard:
            extras.append((torch.sum(~torch.isfinite(x_n))
                           + torch.sum(~torch.isfinite(s_n))
                           + torch.sum(~torch.isfinite(len_))
                           + torch.sum(~torch.isfinite(lin_))).to(ops.dtype))
        want_f = cfg.Ftol is not None and not ops.has_barrier
        if want_f:
            i_f = len(extras)
            extras.append(torch.sum(ops.f_v(x_n, th)))
        want_cent = ops.has_barrier and cfg.mu_strategy != "mehrotra"
        msk_c = ops.im(th) if (ni and ops.imk) else None
        if want_cent:
            i_sl = len(extras)
            extras.append((torch.sum(msk_c * s_n * lin_ if msk_c is not None
                                     else s_n * lin_)) if ni
                          else ops.zeros())
            if msk_c is not None:
                extras.append(torch.sum(msk_c))
        with profiling.annotate("ipm-kkt-residual", dev):
            kktv, ext_g = ops.kkt_norms(x_n, s_n, sc_n, len_, lin_, lcn_,
                                        lcin_, th, ccdata, mu,
                                        extras=tuple(extras))
        st = st._replace(kkt=kktv[None])
        if cfg.nan_guard:
            finite = ((ext_g[0] == 0) & torch.all(torch.isfinite(lcn_))
                      & torch.all(torch.isfinite(sc_n))
                      & torch.all(torch.isfinite(lcin_))
                      & torch.all(torch.isfinite(kktv)))
            st = st._replace(signal=torch.where(
                (st.signal >= 0) & ~finite, torch.full_like(st.signal, -3),
                st.signal))
        if want_f:
            f_new = ext_g[i_f]
            live = st.signal != -2
            hit = live & (torch.abs(st.f_past - f_new) <= abs(cfg.Ftol))
            st = st._replace(
                signal=torch.where(hit, torch.full_like(st.signal, 2),
                                   st.signal),
                f_past=torch.where(live, f_new, st.f_past))
        if want_cent:
            sl_g = ext_g[i_sl] + (torch.sum(sc_n * lcin_) if mci
                                  else ops.zeros())
            ntot_g = (ext_g[i_sl + 1] + mci if msk_c is not None
                      else ops.zeros() + float(x_n.shape[0] * ops.nglob * ni
                                               + mci))
            st = st._replace(g=torch.stack([sl_g, ntot_g])[None])
        return st

    # --- surfaces -----------------------------------------------------
    @_phase("ipm-init")
    def init_state(self, x0, theta, ccdata=None, s0=None, le0=None,
                   li0=None, lc0=None, lci0=None) -> SolverState:
        """This rank's initial state (JAX schur.py:1737-1847): ``x0``
        (K, d) and theta global (this rank's rows are taken), warm starts
        (s0, le0, li0 (K, ...); lc0, lci0 replicated) optional.  With no
        multiplier warm start the multipliers are the least-squares ones
        through the border, negative inequality ones clamped to Ktol."""
        ops, cfg, red = self.ops, self.config, self.reducer
        th, cc = self.local_data(theta, ccdata)
        me, ni, mc, mci = ops.me, ops.ni, ops.mc, ops.mci
        x0 = self._to(x0)
        sl = self._slice(x0.shape[0])
        x = x0[sl]
        Kl = x.shape[0]

        def loc(v):
            return None if v is None else self._to(v)[sl]

        if ni:
            s = (torch.clamp(ops.ci_v(x, th), min=cfg.Ktol) if s0 is None
                 else loc(s0))
            if ops.imk:
                s = torch.where(ops.im(th) > 0, s, torch.ones_like(s))
        else:
            s = ops.zeros(Kl, 0)
        if mci:
            u0 = red.sum(torch.sum(ops.g_v(x, th), dim=0))
            sc = torch.clamp(ops.cci(u0, cc), min=cfg.Ktol).to(ops.dtype)
        else:
            sc = ops.zeros(0)
        mu0 = ops.zeros() + (cfg.mu if ops.has_barrier else cfg.Ktol)
        Kt = cfg.Ktol
        if (le0 is None and li0 is None and lc0 is None and lci0 is None
                and (me + ni + mc + mci) > 0):
            le, li, lc, lci = ops.ls_multiplier_init(x, th, cc)
            if ni:
                li = torch.where(li < 0, torch.full_like(li, Kt), li)
            if mci:
                lci = torch.where(lci < 0, torch.full_like(lci, Kt), lci)
        else:
            le = ops.zeros(Kl, me) if le0 is None else loc(le0)
            li = ops.zeros(Kl, ni) + Kt if li0 is None else loc(li0)
            lc = ops.zeros(mc) if lc0 is None else self._to(lc0)
            lci = ops.zeros(mci) + Kt if lci0 is None else self._to(lci0)
        if me and ops.emk:
            le = le * ops.em(th)
        if ni and ops.imk:
            li = li * ops.im(th)

        want_cent = ops.has_barrier and cfg.mu_strategy != "mehrotra"
        msk_c = ops.im(th) if (ni and ops.imk) else None
        extras = []
        if want_cent:
            extras.append(torch.sum(msk_c * s * li if msk_c is not None
                                    else s * li) if ni else ops.zeros())
            if msk_c is not None:
                extras.append(torch.sum(msk_c))
        kkt0, ext0 = ops.kkt_norms(x, s, sc, le, li, lc, lci, th, cc, mu0,
                                   extras=tuple(extras))
        g0 = None
        if want_cent:
            sl0 = ext0[0] + (torch.sum(sc * lci) if mci else ops.zeros())
            ntot0 = (ext0[1] + mci if msk_c is not None
                     else ops.zeros() + float(Kl * ops.nglob * ni + mci))
            g0 = torch.stack([sl0, ntot0])[None]
        f_past = (ops.fval_g(x, th) if cfg.Ftol is not None
                  else ops.zeros())
        dev = x.device

        def i32():
            return torch.zeros((1,), dtype=torch.int32, device=dev)

        def no():
            return torch.zeros((1,), dtype=torch.bool, device=dev)

        hist = None
        if cfg.trace_metrics:
            T = cfg.niter * cfg.miter
            hist = MetricsHistory(ops.zeros(1, T, 4),
                                  *(ops.zeros(1, T) for _ in range(4)))
        # L-BFGS: every block's memory, x_old seeding the first pair
        mem = (lbfgs_init(Kl, ops.d, cfg.lbfgs_mem, cfg.zeta0, ops.dtype,
                          dev) if cfg.lbfgs else None)
        return SolverState(
            x=x, s=(s, sc), lda=(le, li, lc, lci), mu=_one(mu0),
            nu=_one(ops.zeros() + cfg.nu), delta=ops.zeros(Kl),
            kkt=kkt0[None], signal=i32(), iter_count=i32(), outer=i32(),
            inner=i32(), inner_done=no(), in_inner=no(), f_past=_one(f_past),
            alpha=_one(ops.zeros()), reg_retries=i32(), lbfgs=mem,
            x_old=x if cfg.lbfgs else None, g=g0, hist=hist)

    def run_budget(self, state: SolverState, theta, ccdata=None,
                   max_new_iters=1) -> SolverState:
        """At most ``max_new_iters`` more inner iterations, then pause
        (``signal`` 0); resumes exactly under :meth:`run` or again."""
        p = self.local_data(theta, ccdata)
        return self._loop(state, p,
                          limit=state.iter_count + int(max_new_iters))

    def run(self, state: SolverState, theta, ccdata=None) -> SolverState:
        """Run the solve to its end."""
        return self._loop(state, self.local_data(theta, ccdata))

    @_phase("ipm-finalize")
    def finalize(self, state: SolverState, theta,
                 ccdata=None) -> BlockResult:
        """The result, every rank's blocks gathered (K, ...) on every
        rank."""
        th, _ = self.local_data(theta, ccdata)
        le, li, lc, lci = state.lda
        s, sc = state.s
        g = self.reducer.gather
        hist = (state.hist if state.hist is not None
                else MetricsHistory(self.ops.zeros(1, 0, 4),
                                    *(self.ops.zeros(1, 0)
                                      for _ in range(4))))
        return BlockResult(
            x=g(state.x), s=g(s), le=g(le), li=g(li), lc=lc, sc=sc, lci=lci,
            fval=self.ops.fval_g(state.x, th), kkt=state.kkt[0],
            signal=state.signal[0], iter_count=state.iter_count[0],
            mu=state.mu[0], nu=state.nu[0],
            hist=MetricsHistory(*(h[0] for h in hist)))

    def __call__(self, x0, theta, ccdata=None, s0=None, le0=None, li0=None,
                 lc0=None, lci0=None) -> BlockResult:
        st = self.init_state(x0, theta, ccdata, s0, le0, li0, lc0, lci0)
        return self.finalize(self.run(st, theta, ccdata), theta, ccdata)


def make_block_solver(spec: BlockNLP, mesh=None,
                      config: Optional[IPMConfig] = None,
                      axis: str = "model", device=None) -> BlockSolver:
    """The block-separable solver (JAX schur.py:211-1989).

    Returns ``fn(x0 (K, d), theta, ccdata=None, s0=None, le0=None,
    li0=None, lc0=None, lci0=None) -> BlockResult``, with the surfaces
    ``fn.init_state``, ``fn.run_budget(state, theta, ccdata,
    max_new_iters)``, ``fn.run(state, theta, ccdata)`` and
    ``fn.finalize``.  ``mesh`` (a DeviceMesh) splits the K blocks over
    the ranks of its ``axis`` dimension (K divisible); None runs one
    process.  ``device`` None means the card.  ``config.lbfgs > 0``
    approximates each block's Hessian by its own compact L-BFGS memory
    of that many pairs (the state's ``lbfgs``, split with the blocks)."""
    return BlockSolver(spec, mesh, config, axis, device)


# ----------------------------------------------------------------------
# the box / linear-coupling special case (JAX schur.py:1995-2065)
@dataclasses.dataclass(frozen=True, eq=False)
class SeparableNLP:
    """Box bounds x_k >= lb_k, optional per-block equalities and linear
    coupling sum_k A_k x_k = b; ``f_blk``/``ce_blk`` take ``(x_k,
    theta_k)`` with theta_k the block's slice of ``SeparableData.theta``."""
    f_blk: Callable
    d: int
    mc: int
    has_box: bool = True
    ce_blk: Optional[Callable] = None
    me: int = 0


class SeparableData(NamedTuple):
    theta: dict              # (K, ...) per-block objective data
    A: torch.Tensor          # (K, mc, d) coupling Jacobian blocks
    b: torch.Tensor          # (mc,) coupling rhs
    lb: torch.Tensor         # (K, d) lower bounds


class SeparableResult(NamedTuple):
    x: torch.Tensor
    s: torch.Tensor          # (K, d) slacks (zeros without the box)
    z: torch.Tensor          # (K, d) bound multipliers
    le: torch.Tensor
    lc: torch.Tensor
    fval: torch.Tensor
    kkt: torch.Tensor
    signal: torch.Tensor
    iter_count: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor


def separable_block_spec(spec: SeparableNLP) -> BlockNLP:
    """The :class:`BlockNLP` of a :class:`SeparableNLP`: ci_k = x - lb
    (identity Jacobian), g_k = A_k x_k, cc(u) = u - b."""
    return BlockNLP(
        f_blk=lambda xk, th: spec.f_blk(xk, th["user"]), d=spec.d,
        ce_blk=((lambda xk, th: spec.ce_blk(xk, th["user"]))
                if spec.me else None),
        me=spec.me,
        ci_blk=(lambda xk, th: xk - th["lb"]) if spec.has_box else None,
        ci_identity=spec.has_box, ni=spec.d if spec.has_box else 0,
        g_blk=lambda xk, th: th["A"] @ xk,
        cc=lambda u, ccd: u - ccd["b"], p=spec.mc, mc=spec.mc)


def make_separable_solver(spec: SeparableNLP, mesh=None,
                          config: Optional[IPMConfig] = None,
                          axis: str = "model", device=None):
    """``fn(x0 (K, d), data: SeparableData) -> SeparableResult``, an
    adapter over :func:`make_block_solver`."""
    solve = make_block_solver(separable_block_spec(spec), mesh, config,
                              axis, device)

    def fn(x0, data: SeparableData) -> SeparableResult:
        res = solve(x0, {"user": data.theta, "A": data.A, "lb": data.lb},
                    ccdata={"b": data.b})
        z = res.li if spec.has_box else torch.zeros_like(res.x)
        s = res.s if spec.has_box else torch.zeros_like(res.x)
        return SeparableResult(
            x=res.x, s=s, z=z, le=res.le, lc=res.lc, fval=res.fval,
            kkt=res.kkt, signal=res.signal, iter_count=res.iter_count,
            mu=res.mu, nu=res.nu)

    fn.block_solver = solve
    return fn


# ----------------------------------------------------------------------
# instance families: each spec builder reads only theta and ccdata, so a
# test can drive it with the JAX sampler's data; each sampler draws that
# data from a torch.Generator on a device (the card when None)
def _quad(xk, th):
    return 0.5 * xk @ (th["Q"] @ xk) + th["c"] @ xk


def separable_spec(d: int, mc: int, me: int = 0,
                   has_box: bool = True) -> SeparableNLP:
    """Convex quadratic blocks, optional linear equalities C_k x_k = e_k
    (theta ``Q``, ``c``, ``C``, ``e``), box and linear coupling."""
    return SeparableNLP(
        f_blk=_quad, d=d, mc=mc, has_box=has_box,
        ce_blk=(lambda xk, th: th["C"] @ xk - th["e"]) if me else None,
        me=me)


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def _spd_blocks(gen, K, d, dtype, device):
    G = _randn(gen, (K, d, d), dtype, device) / float(np.sqrt(d))
    return G @ G.transpose(1, 2) + torch.eye(d, dtype=dtype, device=device)


def sample_separable(gen: torch.Generator, K: int, d: int, mc: int,
                     dtype=torch.float32, device=None):
    """A random instance of :func:`separable_spec` (JAX schur.py:2069):
    x = lb + 1 strictly feasible, the coupling rhs from a feasible point.
    Returns (spec, data, x0)."""
    dev = resolve_device(device)
    Q = _spd_blocks(gen, K, d, dtype, dev)
    c = _randn(gen, (K, d), dtype, dev)
    A = _randn(gen, (K, mc, d), dtype, dev) / float(np.sqrt(K * d))
    lb = torch.full((K, d), -2.0, dtype=dtype, device=dev)
    xfeas = _randn(gen, (K, d), dtype, dev) * 0.1
    b = torch.einsum("kcd,kd->c", A, xfeas)
    data = SeparableData(theta={"Q": Q, "c": c}, A=A, b=b, lb=lb)
    return separable_spec(d, mc), data, torch.zeros((K, d), dtype=dtype,
                                                    device=dev)


def sample_separable_eq(gen: torch.Generator, K: int, d: int, mc: int,
                        me: int = 1, dtype=torch.float32, device=None,
                        has_box: bool = True):
    """The same with per-block linear equalities, feasible at a reference
    point (JAX schur.py:2092).  Returns (spec, data, x0)."""
    dev = resolve_device(device)
    Q = _spd_blocks(gen, K, d, dtype, dev)
    c = _randn(gen, (K, d), dtype, dev)
    A = _randn(gen, (K, mc, d), dtype, dev) / float(np.sqrt(K * d))
    Ck = _randn(gen, (K, me, d), dtype, dev) / float(np.sqrt(d))
    lb = torch.full((K, d), -3.0, dtype=dtype, device=dev)
    xfeas = _randn(gen, (K, d), dtype, dev) * 0.1
    b = torch.einsum("kcd,kd->c", A, xfeas)
    e = torch.einsum("kmd,kd->km", Ck, xfeas)
    data = SeparableData(theta={"Q": Q, "c": c, "C": Ck, "e": e}, A=A, b=b,
                         lb=lb)
    return (separable_spec(d, mc, me, has_box), data,
            torch.zeros((K, d), dtype=dtype, device=dev))


def _lin_con(xk, th):
    return th["Ce"] @ xk - th["e"]


def _lin_ineq(xk, th):
    return th["Ci"] @ xk + th["di"]


def block_ragged_spec(d: int = 4, me: int = 2, ni: int = 3, p: int = 2,
                      mc: int = 1) -> BlockNLP:
    """Quadratic blocks, masked linear equalities and inequalities
    (theta ``ce_mask``/``ci_mask``), linear pooled features G_k x_k and
    cc(u) = (u - u0)[:mc] (ccdata ``u0``)."""
    return BlockNLP(
        f_blk=_quad, d=d, ce_blk=_lin_con, me=me, ci_blk=_lin_ineq, ni=ni,
        g_blk=lambda xk, th: th["G"] @ xk,
        cc=lambda u, ccd: (u - ccd["u0"])[:mc], p=p, mc=mc,
        ce_mask_key="ce_mask", ci_mask_key="ci_mask")


def block_general_spec(d: int, me: int = 1, ni: int = 2, p: int = 2,
                       mc: int = 1, mci: int = 0,
                       nonlinear_cc: bool = True) -> BlockNLP:
    """Quadratic blocks, linear per-block equalities and inequalities,
    quadratic pooled features g_k = G_k x + 0.05 (G_k x)^2, and a coupling
    cc (nonlinear, or affine with ``linear_coupling``) and optional
    nonlinear caps cci (JAX schur.py:2185-2256)."""
    def g_blk(xk, th):
        base = th["G"] @ xk
        return base + 0.05 * base ** 2

    if nonlinear_cc:
        def cc(u, ccd):
            v = u - ccd["u0"]
            return v[:mc] + 0.1 * torch.sum(v ** 2) * torch.ones(
                (mc,), dtype=v.dtype, device=v.device)
    else:
        def cc(u, ccd):
            return (u - ccd["u0"])[:mc]

    def cci(u, ccd):
        v = u - ccd["u0"]
        return 0.5 - (v[:mci] + 0.05 * torch.sum(v ** 2) * torch.ones(
            (mci,), dtype=v.dtype, device=v.device))

    coupled = mc > 0 or mci > 0
    return BlockNLP(
        f_blk=_quad, d=d, ce_blk=_lin_con if me else None, me=me,
        ci_blk=_lin_ineq if ni else None, ni=ni,
        g_blk=g_blk if coupled else None, cc=cc if mc else None,
        p=p if coupled else 0, mc=mc, cci=cci if mci else None, mci=mci,
        linear_coupling=not nonlinear_cc)


def _block_data(gen, K, d, me, ni, p, dtype, dev):
    Q = _spd_blocks(gen, K, d, dtype, dev)
    c = _randn(gen, (K, d), dtype, dev)
    Ce = _randn(gen, (K, me, d), dtype, dev) / float(np.sqrt(d))
    Ci = _randn(gen, (K, ni, d), dtype, dev) / float(np.sqrt(d))
    G = _randn(gen, (K, p, d), dtype, dev) / float(np.sqrt(K * d))
    xfeas = _randn(gen, (K, d), dtype, dev) * 0.1
    e = torch.einsum("kmd,kd->km", Ce, xfeas)
    di = 1.0 - torch.einsum("knd,kd->kn", Ci, xfeas)
    theta = {"Q": Q, "c": c, "Ce": Ce, "e": e, "Ci": Ci, "di": di, "G": G}
    return theta, xfeas


def sample_block_general(gen: torch.Generator, K: int, d: int, me: int = 1,
                         ni: int = 2, p: int = 2, mc: int = 1, mci: int = 0,
                         dtype=torch.float64, device=None,
                         nonlinear_cc: bool = True):
    """A random instance of :func:`block_general_spec`, feasible at a
    reference point.  Returns (spec, theta, ccdata, x0)."""
    dev = resolve_device(device)
    spec = block_general_spec(d, me, ni, p, mc, mci, nonlinear_cc)
    theta, xfeas = _block_data(gen, K, d, me, ni, p, dtype, dev)
    base = torch.einsum("kpd,kd->kp", theta["G"], xfeas)
    ccdata = {"u0": torch.sum(base + 0.05 * base ** 2, dim=0)}
    return spec, theta, ccdata, torch.zeros((K, d), dtype=dtype, device=dev)


def sample_block_ragged(gen: torch.Generator, K: int, d: int = 4,
                        me: int = 2, ni: int = 3, p: int = 2, mc: int = 1,
                        dtype=torch.float64, device=None):
    """A random instance of :func:`block_ragged_spec`: per-block counts
    me_k in 1..me and ni_k in ni-1..ni under masks, junk in the inactive
    rows (JAX schur.py:2122).  Returns (spec, theta, ccdata, x0,
    me_counts, ni_counts)."""
    dev = resolve_device(device)
    me_counts = torch.randint(1, me + 1, (K,), generator=gen,
                              device=dev)
    ni_counts = torch.randint(max(ni - 1, 1), ni + 1, (K,), generator=gen,
                              device=dev)
    ce_mask = (torch.arange(me, device=dev)[None] < me_counts[:, None])
    ci_mask = (torch.arange(ni, device=dev)[None] < ni_counts[:, None])
    theta, xfeas = _block_data(gen, K, d, me, ni, p, dtype, dev)
    junk = 37.0                   # violated if masking ever leaked them
    theta["e"] = torch.where(ce_mask, theta["e"], junk)
    theta["di"] = torch.where(ci_mask, theta["di"], -junk)
    theta["ce_mask"] = ce_mask.to(dtype)
    theta["ci_mask"] = ci_mask.to(dtype)
    ccdata = {"u0": torch.einsum("kpd,kd->p", theta["G"], xfeas)}
    return (block_ragged_spec(d, me, ni, p, mc), theta, ccdata,
            torch.zeros((K, d), dtype=dtype, device=dev), me_counts,
            ni_counts)


def _diag_quad(xk, th):
    return 0.5 * xk @ (th["q"] * xk) + th["c"] @ xk


def block_box_quadratic_spec(d: int, p: int) -> BlockNLP:
    """Diagonal quadratic blocks 0.5 x'diag(q)x + c'x (theta ``q``,
    ``c``), bounds x >= lb through the identity Jacobian (``lb``) and
    linear coupling sum_k A_k x_k = b over p features (``A``; ccdata
    ``b``): no (d, d) data, the per-block L-BFGS mode's large-block
    family (JAX benchmarks/bench_lbfgs_block.py:48-70)."""
    return BlockNLP(
        f_blk=_diag_quad, d=d, ci_blk=box_ci("lb"), ni=d, ci_identity=True,
        g_blk=lambda xk, th: th["A"] @ xk, cc=lambda u, ccd: u - ccd["b"],
        p=p, mc=p)


def sample_block_box_quadratic(gen: torch.Generator, K: int, d: int,
                               p: int = 4, dtype=torch.float32,
                               device=None):
    """A random instance of :func:`block_box_quadratic_spec`: q = 0.5 +
    U(0, 1), c ~ N(0, 1), A ~ N(0, 1)/sqrt(K d), lb = -3, b = A x_feas
    with x_feas ~ 0.1 N(0, 1).  Returns (spec, theta, ccdata, x0)."""
    dev = resolve_device(device)
    q = 0.5 + torch.rand((K, d), generator=gen, dtype=dtype, device=dev)
    c = _randn(gen, (K, d), dtype, dev)
    A = _randn(gen, (K, p, d), dtype, dev) / float(np.sqrt(K * d))
    lb = torch.full((K, d), -3.0, dtype=dtype, device=dev)
    xfeas = _randn(gen, (K, d), dtype, dev) * 0.1
    theta = {"q": q, "c": c, "A": A, "lb": lb}
    ccdata = {"b": torch.einsum("kpd,kd->p", A, xfeas)}
    return (block_box_quadratic_spec(d, p), theta, ccdata,
            torch.zeros((K, d), dtype=dtype, device=dev))


# ----------------------------------------------------------------------
# numpy-seeded samplers: the families above drawn from
# ``np.random.default_rng(seed)``, numpy arrays out (the CPU cannot replay
# a CUDA generator's stream, so a reference computed off the card needs
# these).  Normals lie on a grid of 2^-16 and are kept as int64 multiples
# of it (|n| < 2^21) until every product is formed: a per-block dot of d
# < 2^21 terms is exact in int64, a (d, d) Gram block of d <= 2048 is
# exact in float64 whatever order the BLAS sums in (torch's CPU product,
# the faster one), and a sum over blocks is ``math.fsum``'s correctly
# rounded one, so every machine draws the same bits.  Each array is
# rounded once to ``dtype``.
_GRID = 2.0 ** 16
_NMAX = 2 ** 21 - 1
_GRAM_CHUNK = 2048               # d * 2^42 < 2^53: exact in float64


def _grid_normal(rng, shape):
    """N(0, 1) draws as int64 multiples of 2^-16."""
    return np.clip(np.rint(rng.standard_normal(shape) * _GRID), -_NMAX,
                   _NMAX).astype(np.int64)


def _spd_arrays(rng, K, d, dtype):
    """Q = G G^T / d + I with G ~ N(0, 1) (the torch samplers' G / sqrt(d)
    squared), formed exactly and rounded once to ``dtype``; drawn in
    chunks of blocks (the same stream as one draw)."""
    Q = np.empty((K, d, d), dtype)
    kc = max(1, 2 ** 22 // (d * d))
    for k0 in range(0, K, kc):
        G = _grid_normal(rng, (min(kc, K - k0), d, d)).astype(np.float64)
        P = np.zeros(G.shape, np.int64)
        for j0 in range(0, d, _GRAM_CHUNK):
            g = torch.from_numpy(G[..., j0:j0 + _GRAM_CHUNK])
            P += (g @ g.mT).numpy().astype(np.int64)
        Q[k0:k0 + len(G)] = P / (_GRID ** 2 * d) + np.eye(d)
    return Q


def _block_dot(subscripts, a, b):
    """A per-block ``einsum`` of two int64 grid arrays, exact, as float64
    (one rounding where the sum passes 2^53)."""
    return np.einsum(subscripts, a, b).astype(np.float64)


def _fsum_blocks(v):
    """The sum over the leading (block) axis, correctly rounded."""
    flat = v.reshape(v.shape[0], -1)
    return np.array([math.fsum(col) for col in flat.T.tolist()]).reshape(
        v.shape[1:])


def sample_separable_arrays(seed: int, K: int, d: int, mc: int,
                            dtype=np.float32) -> dict:
    """:func:`sample_separable`'s family from a numpy seed: {"theta":
    {"Q", "c"}, "A", "b", "lb"}, the fields of :class:`SeparableData`
    (``interop.separable_data_from_numpy``); x0 is zeros."""
    rng = np.random.default_rng(seed)
    Q = _spd_arrays(rng, K, d, dtype)
    c = _grid_normal(rng, (K, d))
    A = _grid_normal(rng, (K, mc, d))
    xf = _grid_normal(rng, (K, d))
    scale = _GRID * np.sqrt(K * d)
    b = _fsum_blocks(_block_dot("kcd,kd->kc", A, xf) * (0.1 / (_GRID
                                                               * scale)))
    return dict(theta=dict(Q=Q, c=(c / _GRID).astype(dtype)),
                **_cast(dict(A=A / scale, b=b, lb=np.full((K, d), -2.0)),
                        dtype))


def _block_arrays(rng, K, d, me, ni, p, dtype):
    """``_block_data`` from a numpy generator: (theta, Q in ``dtype`` and
    the rest in float64; G and xfeas as grid integers)."""
    Q = _spd_arrays(rng, K, d, dtype)
    c = _grid_normal(rng, (K, d))
    Ce = _grid_normal(rng, (K, me, d))
    Ci = _grid_normal(rng, (K, ni, d))
    G = _grid_normal(rng, (K, p, d))
    xf = _grid_normal(rng, (K, d))
    sd = _GRID * np.sqrt(d)
    theta = dict(Q=Q, c=c / _GRID, Ce=Ce / sd,
                 e=_block_dot("kmd,kd->km", Ce, xf) * (0.1 / (_GRID * sd)),
                 Ci=Ci / sd,
                 di=1.0 - _block_dot("knd,kd->kn", Ci, xf) * (
                     0.1 / (_GRID * sd)),
                 G=G / (_GRID * np.sqrt(K * d)))
    return theta, G, xf


def sample_block_general_arrays(seed: int, K: int, d: int, me: int = 1,
                                ni: int = 2, p: int = 2,
                                dtype=np.float64) -> tuple:
    """:func:`sample_block_general`'s family from a numpy seed (the spec:
    :func:`block_general_spec`, whose coupling counts and form do not
    change the data): (theta, ccdata); x0 is zeros."""
    rng = np.random.default_rng(seed)
    theta, G, xf = _block_arrays(rng, K, d, me, ni, p, dtype)
    base = _block_dot("kpd,kd->kp", G, xf) * (
        0.1 / (_GRID ** 2 * np.sqrt(K * d)))
    u0 = _fsum_blocks(base + 0.05 * base ** 2)
    return _cast(theta, dtype), _cast(dict(u0=u0), dtype)


def sample_block_ragged_arrays(seed: int, K: int, d: int = 4, me: int = 2,
                               ni: int = 3, p: int = 2,
                               dtype=np.float64) -> tuple:
    """:func:`sample_block_ragged`'s family from a numpy seed (the spec:
    :func:`block_ragged_spec`): (theta, ccdata, me_counts, ni_counts),
    junk in the rows outside the masks; x0 is zeros."""
    rng = np.random.default_rng(seed)
    me_counts = rng.integers(1, me + 1, size=K)
    ni_counts = rng.integers(max(ni - 1, 1), ni + 1, size=K)
    ce_mask = np.arange(me)[None] < me_counts[:, None]
    ci_mask = np.arange(ni)[None] < ni_counts[:, None]
    theta, G, xf = _block_arrays(rng, K, d, me, ni, p, dtype)
    junk = 37.0
    theta["e"] = np.where(ce_mask, theta["e"], junk)
    theta["di"] = np.where(ci_mask, theta["di"], -junk)
    theta.update(ce_mask=ce_mask, ci_mask=ci_mask)
    u0 = _fsum_blocks(_block_dot("kpd,kd->kp", G, xf) * (
        0.1 / (_GRID ** 2 * np.sqrt(K * d))))
    return (_cast(theta, dtype), _cast(dict(u0=u0), dtype), me_counts,
            ni_counts)


def sample_block_box_quadratic_arrays(seed: int, K: int, d: int,
                                      p: int = 4,
                                      dtype=np.float32) -> tuple:
    """:func:`sample_block_box_quadratic`'s family from a numpy seed (the
    spec: :func:`block_box_quadratic_spec`): (theta, ccdata); x0 is
    zeros."""
    rng = np.random.default_rng(seed)
    q = 0.5 + rng.random((K, d))
    c = _grid_normal(rng, (K, d))
    A = _grid_normal(rng, (K, p, d))
    xf = _grid_normal(rng, (K, d))
    scale = _GRID * np.sqrt(K * d)
    b = _fsum_blocks(_block_dot("kpd,kd->kp", A, xf) * (0.1 / (_GRID
                                                               * scale)))
    theta = dict(q=q, c=c / _GRID, A=A / scale, lb=np.full((K, d), -3.0))
    return _cast(theta, dtype), _cast(dict(b=b), dtype)
