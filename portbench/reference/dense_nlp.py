"""Plain reference for the dense NLP family: judges each answer of the
port by what it says, from the instance the benchmark drew and the
answer's x, multipliers, f and signal, in float64.

An answer says: the instance converged (signal 1) to a point whose KKT
conditions hold to Ktol, Aeq x = beq holds, and f is the objective there.
The gradient is written out: P x + c + alpha W' (1 - tanh^2(Wx/sqrt D))
/ sqrt D.  Imports torch alone.
"""

import math

import torch


def judge(inst, ans) -> dict:
    """Per-instance numbers, each (B,) (a single answer is a batch of
    one):

      - ``unconverged``: 1 where the signal is not 1;
      - ``stationarity``: |grad f - Aeq' lda|_2;
      - ``feas``: |Aeq x - beq|_inf, which the solver keeps to rounding
        once a full step is taken;
      - ``fval``: |f reported - f(x)| / (1 + |f(x)|)."""
    P, c, W, Aeq, beq, alpha = (t.to(torch.float64) for t in inst)
    x, lda = ans.x.to(torch.float64), ans.lda.to(torch.float64)
    if x.dim() == 1:
        P, c, W, Aeq, beq, alpha = (t.unsqueeze(0) for t in
                                    (P, c, W, Aeq, beq, alpha))
        x, lda = x.unsqueeze(0), lda.unsqueeze(0)
        signal, fval = ans.signal.reshape(1), ans.fval.reshape(1)
    else:
        signal, fval = ans.signal, ans.fval
    sqrtD = math.sqrt(x.shape[-1])
    Px = torch.einsum("bij,bj->bi", P, x)
    t = torch.tanh(torch.einsum("bhd,bd->bh", W, x) / sqrtD)
    grad = (Px + c + alpha[:, None]
            * torch.einsum("bhd,bh->bd", W, 1.0 - t * t) / sqrtD)
    stat = torch.linalg.vector_norm(
        grad - torch.einsum("bmd,bm->bd", Aeq, lda), dim=-1)
    feas = torch.amax(torch.abs(torch.einsum("bmd,bd->bm", Aeq, x) - beq),
                      dim=-1)
    f = (0.5 * torch.sum(x * Px, dim=-1) + torch.sum(c * x, dim=-1)
         + alpha * torch.sum(t, dim=-1))
    return {
        "unconverged": (signal != 1).to(torch.float64),
        "stationarity": stat,
        "feas": feas,
        "fval": (torch.abs(fval.to(torch.float64) - f)
                 / (1.0 + torch.abs(f))),
    }
