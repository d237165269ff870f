"""A fleet of independent NLP instances on one card through the
wave-compacted batch solver: converged instances retire, and only the
instances still running take the next wave.

Each instance is a random inequality-constrained QP of one family (one
Problem, per-instance data as ``params``), solved with the Mehrotra
predictor-corrector barrier.

    python -m pyipm_tpu_torch.examples.batched_fleet [--batch B] [--device cpu]
"""

import argparse

import numpy as np
import torch

from pyipm_tpu_torch import IPMConfig, make_wave_batch_solver
from pyipm_tpu_torch.models.random_nlp import make_qp_problem, sample_qp_batch


def main(batch=512, nvar=8, nlin=3, device="cuda"):
    cfg = IPMConfig(float_dtype="float32", verbosity=0,
                    mu_strategy="mehrotra")   # predictor-corrector barrier
    solver = make_wave_batch_solver(make_qp_problem(nvar, nlin), cfg,
                                    first_wave=8, wave=16)
    data = sample_qp_batch(0, batch, nvar, nlin, device=device)
    x0 = torch.zeros((batch, nvar), device=data.c.device)
    res = solver(x0, data)

    sigs = res.signal.cpu().numpy()
    iters = res.iter_count.cpu().numpy()
    print(f"{batch} instances: "
          f"{int(np.sum(np.isin(sigs, (1, 2))))} converged, "
          f"mean {iters.mean():.1f} iterations, "
          f"max KKT residual {float(res.kkt.max()):.2e}")
    assert np.mean(np.isin(sigs, (1, 2))) > 0.99
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    main(batch=args.batch, device=args.device)
