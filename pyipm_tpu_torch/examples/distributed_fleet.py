"""A fleet of independent instances split over ranks: each rank solves
its slice of the global batch with no collective, and the result is
gathered onto every rank.  Run it through the launcher::

    python -m pyipm_tpu_torch.parallel.launch --spawn 2 \\
        pyipm_tpu_torch/examples/distributed_fleet.py --device cpu

or alone (one process).  On one card with two ranks name gloo
(``--backend gloo``): NCCL refuses two ranks on one device.
"""

import argparse

import numpy as np
import torch

from pyipm_tpu_torch import IPMConfig
from pyipm_tpu_torch.models.reference_problems import get_problem
from pyipm_tpu_torch.parallel import distributed as dist
from pyipm_tpu_torch.parallel.batch import make_batch_solver


def main(device="cuda", backend=None, batch=8, out=None):
    dist.initialize(device=device, backend=backend)
    ranks = dist.world_size()
    mesh = dist.global_batch_mesh(device=device) if ranks > 1 else None
    B = batch                         # global: every rank's instances
    spec = get_problem(9)
    rng = np.random.default_rng(7)
    x0 = torch.tensor(np.stack([spec.sample_x0(rng) for _ in range(B)]),
                      dtype=torch.float64, device=device)
    fn = make_batch_solver(spec.make(), IPMConfig(verbosity=0), mesh=mesh)
    res = fn(x0)
    sigs = res.signal.cpu().numpy()
    if dist.rank() == 0:
        print(f"{B} instances over {ranks} process(es): "
              f"{int(np.sum(np.isin(sigs, (1, 2))))} converged")
        if out:
            np.savez(out, signal=sigs,
                     iter_count=res.iter_count.cpu().numpy(),
                     x=res.x.cpu().numpy())
    assert np.all(np.isin(sigs, (1, 2)))
    dist.shutdown()
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch (a multiple of the world size)")
    ap.add_argument("--out", default=None,
                    help="rank 0 writes signals, iterations and x here")
    a = ap.parse_args()
    main(device=a.device, backend=a.backend, batch=a.batch, out=a.out)
