"""Plain reference for the Markowitz family: judges each answer of the
port by what it says, from the instance the benchmark drew and the
answer's x, s, multipliers, f and signal, in float64.

An answer with signal 1 says: x is an optimal portfolio.  The problem is
a convex QP, so that means its KKT conditions hold to Ktol at the barrier
0: the Lagrangian's gradient vanishes, lda_i o ci(x) vanishes with
lda_i >= 0, the portfolio is fully invested and inside its caps, and f is
the objective there.  A central point of a positive barrier mu (every
lda_i c_i = mu) is no answer: its complementarity reads sqrt(2D) mu, and
its objective lies up to 2D mu above the optimum.  The multipliers are
laid out as the problem's constraints: [lda_e (1); lda_i (2D)] for
ce = sum(x) - 1 and ci = [x; cap - x].  Imports torch alone.
"""

import torch


def judge(book, ans) -> dict:
    """Per-instance numbers, each (B,):

      - ``unconverged``: 1 where the signal is not 1;
      - ``stationarity``: |grad f - J' lda|_2;
      - ``complementarity``: |lda_i o ci(x)|_2, at the barrier 0;
      - ``dual``: the largest negative inequality multiplier (the
        method keeps them positive);
      - ``feas``: the largest of |sum(x) - 1|, a bound's violation and
        |ci(x) - s|, which the solver keeps to rounding;
      - ``fval``: |f reported - f(x)| / (1 + |f(x)|)."""
    S, m, gamma, cap = (t.to(torch.float64) for t in book)
    x, s, lda = (t.to(torch.float64) for t in (ans.x, ans.s, ans.lda))
    D = x.shape[-1]
    Sx = torch.einsum("bij,bj->bi", S, x)
    grad = 2.0 * Sx - gamma[:, None] * m
    le, lo, hi = lda[:, :1], lda[:, 1:D + 1], lda[:, D + 1:]
    ci = torch.cat([x, cap - x], dim=-1)
    li = lda[:, 1:]
    f = torch.sum(x * Sx, dim=-1) - gamma * torch.sum(m * x, dim=-1)
    feas = torch.stack([torch.abs(torch.sum(x, dim=-1) - 1.0),
                        torch.clamp(-torch.amin(ci, dim=-1), min=0.0),
                        torch.amax(torch.abs(ci - s), dim=-1)]).amax(0)
    return {
        "unconverged": (ans.signal != 1).to(torch.float64),
        "stationarity": torch.linalg.vector_norm(grad - le - lo + hi,
                                                 dim=-1),
        "complementarity": torch.linalg.vector_norm(li * ci, dim=-1),
        "dual": torch.clamp(-torch.amin(li, dim=-1), min=0.0),
        "feas": feas,
        "fval": (torch.abs(ans.fval.to(torch.float64) - f)
                 / (1.0 + torch.abs(f))),
    }
