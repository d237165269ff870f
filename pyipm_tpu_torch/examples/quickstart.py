"""Quick start: the class facade on the reference's example problem 7.

    max xyz   s.t.  x + y + z = 1,  x, y, z >= 0

(reference pyipm.py:2043-2064; ground truth x = y = z = 1/3).  The
reference's surface: construct ``IPM`` with plain callables (here taking
``(x, p)``, the instance's data ``p`` unused), call ``solve()``, get the
5-tuple ``(x, s, lda, fval, kkt)``.

    python -m pyipm_tpu_torch.examples.quickstart [--device cpu]
"""

import argparse

import numpy as np
import torch

from pyipm_tpu_torch import IPM


def main(device="cuda"):
    problem = IPM(
        x0=np.array([0.2, 0.3, 0.5]),
        f=lambda x, p: -x[0] * x[1] * x[2],        # maximize xyz
        ce=lambda x, p: torch.stack([x[0] + x[1] + x[2] - 1.0]),
        ci=lambda x, p: x,                         # x, y, z >= 0
        Ftol=1e-8, device=device,
    )
    x, s, lda, fval, kkt = problem.solve()
    print("x     =", x)
    print("s     =", s)
    print("lda   =", lda)
    print("f(x)  =", fval)
    print("KKT   =", [np.asarray(k) for k in kkt])
    assert np.allclose(x, 1.0 / 3.0, atol=1e-3)
    return x


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    main(ap.parse_args().device)
