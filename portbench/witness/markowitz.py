"""A second witness for the Markowitz family, independent of the program
and of the reference's test: the optimum of one instance by SciPy's SLSQP
(an active-set SQP method) on the host, in float64.  ``readings.py
--witness`` compares the program's objective with it."""

import numpy as np
from scipy.optimize import minimize


def optimum(book, row: int) -> dict:
    """SLSQP from the uniform start on instance ``row`` of ``book``:
    its objective, iterations, status and feasibility."""
    S, m, gamma, cap = (t[row].double().cpu().numpy() for t in book)
    g = float(gamma)
    D = m.shape[0]
    res = minimize(lambda x: x @ S @ x - g * (m @ x), np.full(D, 1.0 / D),
                   jac=lambda x: 2.0 * (S @ x) - g * m, method="SLSQP",
                   bounds=list(zip(np.zeros(D), cap)),
                   constraints=[{"type": "eq", "fun": lambda x: x.sum() - 1,
                                 "jac": lambda x: np.ones(D)}],
                   options={"ftol": 1e-15, "maxiter": 2000})
    x = res.x
    return {"f": float(res.fun), "nit": int(res.nit),
            "status": int(res.status),
            "feas": float(max(abs(x.sum() - 1.0), max(-x.min(), 0.0),
                              max((x - cap).max(), 0.0)))}
