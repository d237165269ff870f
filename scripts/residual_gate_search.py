"""Search for KKT systems that trip the residual gate of the port's small
``reg_solve_kkt`` on its own factor and solve (the plain versions on the
CPU, bitwise those of the kernels), and hold its decision to the JAX
package's kernel path (Pallas in interpret mode).

    JAX_PLATFORMS=cpu python scripts/residual_gate_search.py [--trials N]
        [--seed S] [--jax K]

Each trial is a KKT system [[w, 0, a], [0, e2, b], [a, b, 0]] (D = 2,
M = 1) whose first primal pivot w sits just past -delta0: the first shift
of the escalation makes it tiny, and the escalation accepts that factor on
inertia alone.  Prints, per dtype, how many trials trip the gate (counted
as substitutions beyond the first refined solve), how close to zero the
shifted pivot was, the backward errors of the unrefined and the refined
solve of the worst case, and, for the first K hits in float32, whether the
JAX package decides the same (delta_new, retries).  CPU only.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pyipm_tpu_torch.config import IPMConfig  # noqa: E402
from pyipm_tpu_torch.ops import linalg as TL  # noqa: E402


def system(rng, delta0, dtype):
    """One trial: (H, g, dp) with w = -delta0 (1 - s dp)."""
    dp = 10 ** rng.uniform(-7, -2)
    a = rng.uniform(0.5, 8)
    e2 = 10 ** rng.uniform(-12 if dtype == "float64" else -9, 0)
    b = rng.uniform(-1, 1) * 10 ** rng.uniform(-5, 0)
    w = -delta0 * (1 - rng.choice([-1.0, 1.0]) * dp)
    H = np.array([[w, 0, a], [0, e2, b], [a, b, 0.0]])
    g = (rng.standard_normal(3) if rng.random() < 0.5
         else H @ rng.standard_normal(3))
    return H, g, dp


def port_gate(H, g, cfg, kw):
    """(gate firings, delta_new, retries, backward errors) of the port."""
    tdt = cfg.torch_dtype
    subs = []
    solve = TL.ldlt_solve_small

    def counted(*a, **k):
        subs.append(1)
        return solve(*a, **k)

    TL.ldlt_solve_small = counted
    try:
        Ht, gt = torch.tensor(H[None], dtype=tdt), torch.tensor(g[None],
                                                               dtype=tdt)
        dz, dn, rt = TL.reg_solve_kkt(Ht, gt, torch.zeros(1, dtype=tdt),
                                      torch.full((1,), 0.1, dtype=tdt), **kw)
    finally:
        TL.ldlt_solve_small = solve
    return (len(subs) - 2) // 2, float(dn[0]), int(rt[0])


def backward_errors(H, g, dlt, cfg):
    """Normwise backward errors of the unrefined and the once-refined solve
    against H + dlt on the primal block, with the port's scaled factor."""
    tdt = cfg.torch_dtype
    Ht, gt = torch.tensor(H[None], dtype=tdt), torch.tensor(g[None],
                                                           dtype=tdt)
    ex = torch.tensor([1.0, 1.0, 0.0], dtype=tdt)
    Hs, dsc = TL.ruiz_scale(Ht)
    d = torch.tensor([dlt], dtype=tdt)
    L, dv = TL.ldlt_factor_small(TL._shifted(
        Hs, d, dsc * dsc * ex, torch.zeros(1, dtype=tdt),
        dsc * dsc * (1 - ex)))

    def mv(y):
        return TL.matvec(Ht, y) + d[:, None] * ex * y

    def bkw(y):
        r = torch.linalg.vector_norm(gt - mv(y))
        hn = torch.linalg.matrix_norm(Ht) + d * torch.sqrt(ex.sum())
        return float(r / (hn * torch.linalg.vector_norm(y)
                          + torch.linalg.vector_norm(gt)))

    y = TL.ldlt_solve_small(L, dv, gt, scale=dsc)
    y2 = y + TL.ldlt_solve_small(L, dv, gt - mv(y), scale=dsc)
    return bkw(y), bkw(y2)


def jax_decision(H, g, cfg, kw):
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from pyipm_tpu.ops import pallas_ldlt as pk
    from pyipm_tpu.ops.linalg import reg_solve_kkt

    pk._lane_dispatch = lambda n, b, dt: True
    jdt = jnp.dtype(cfg.float_dtype)
    with pltpu.force_tpu_interpret_mode():
        out = jax.jit(lambda H_, g_: reg_solve_kkt(
            H_, g_, jnp.zeros((), jdt), jnp.asarray(0.1, jdt),
            method="ldlt", **kw)[:3])(jnp.asarray(H, jdt),
                                      jnp.asarray(g, jdt))
    return float(out[1]), int(out[2])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=3000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--jax", type=int, default=8,
                    help="hold the first K float32 hits to the JAX package")
    args = ap.parse_args()
    for dtype in ("float32", "float64"):
        cfg = IPMConfig(float_dtype=dtype)
        kw = dict(nvar=2, neq=1, nineq=0, eps=cfg.eps,
                  reg_coef=cfg.reg_coef, eta=cfg.eta, beta=cfg.beta,
                  delta0=cfg.delta0, max_retries=20)
        rng = np.random.default_rng(args.seed)
        hits, worst = [], (0.0, None)
        for _ in range(args.trials):
            H, g, dp = system(rng, cfg.delta0, dtype)
            fired, dn, rt = port_gate(H, g, cfg, kw)
            if fired:
                hits.append((H, g, dp, dn, rt))
            b0, _ = backward_errors(H, g, cfg.delta0, cfg)
            if b0 > worst[0]:
                worst = (b0, (H, g))
        small = sum(h[2] < 1e-6 for h in hits)
        b0, b1 = backward_errors(*worst[1], cfg.delta0, cfg)
        print(f"{dtype}: {len(hits)} of {args.trials} systems trip the "
              f"gate, {small} of them with dp < 1e-6 (the shifted pivot "
              f"within ~dp of zero, relative to delta0); worst unrefined "
              f"backward error {b0:.3e}, refined {b1:.3e}", flush=True)
        if dtype == "float32" and args.jax:
            same = 0
            for H, g, dp, dn, rt in hits[:args.jax]:
                jdn, jrt = jax_decision(H, g, cfg, kw)
                agree = np.isclose(jdn, dn, rtol=1e-6) and jrt == rt
                same += bool(agree)
                print(f"  dp {dp:.3e}: port delta_new {dn:.6e} retries {rt};"
                      f" JAX {jdn:.6e} retries {jrt}; "
                      f"{'agree' if agree else 'differ'}", flush=True)
            print(f"  the JAX kernel path agrees on {same} of "
                  f"{min(args.jax, len(hits))}", flush=True)


if __name__ == "__main__":
    main()
