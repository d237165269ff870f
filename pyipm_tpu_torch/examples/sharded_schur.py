"""One large block-separable NLP whose blocks are split over ranks: the
condensed KKT system's Schur complement over the coupling is reduced with
one small all-reduce per phase, the per-block linear algebra stays local.

Runs at any world size, one process included::

    python -m pyipm_tpu_torch.examples.sharded_schur --device cpu
    python -m pyipm_tpu_torch.parallel.launch --spawn 2 \\
        pyipm_tpu_torch/examples/sharded_schur.py --device cpu

(On one card with two ranks, name gloo: ``--backend gloo``; NCCL refuses
two ranks on one device.)
"""

import argparse

import torch

from pyipm_tpu_torch import IPMConfig
from pyipm_tpu_torch.parallel import distributed as dist
from pyipm_tpu_torch.parallel.schur import (
    make_block_solver, make_separable_solver, sample_block_general,
    sample_separable,
)


def main(device="cuda", backend=None, K=16, d=32, mc=4):
    dist.initialize(device=device, backend=backend)
    ranks = dist.world_size()
    mesh = (dist.global_solver_mesh(batch=1, model=ranks, device=device)
            if ranks > 1 else None)
    cfg = IPMConfig(float_dtype="float32", verbosity=0)
    gen = torch.Generator(device=device).manual_seed(0)
    spec, data, x0 = sample_separable(gen, K, d, mc, device=device)
    res = make_separable_solver(spec, mesh, cfg, device=device)(x0, data)
    out = [f"{K * d} variables in {K} blocks over {ranks} rank(s): "
           f"signal={int(res.signal)}, kkt={res.kkt.cpu().numpy()}"]
    assert int(res.signal) in (1, 2)

    # full generality: nonlinear per-block and coupling constraints
    gspec, th, cc, gx0 = sample_block_general(gen, K, 3, me=1, ni=2, p=2,
                                              mc=1, dtype=torch.float32,
                                              device=device)
    gres = make_block_solver(gspec, mesh, cfg, device=device)(gx0, th, cc)
    out.append(f"general block NLP (nonlinear coupling): "
               f"signal={int(gres.signal)}, kkt={gres.kkt.cpu().numpy()}")
    assert int(gres.signal) in (1, 2)

    # affine coupling declared: the pooled features, the border and the
    # first bordered solve share one all-reduce
    lspec, lth, lcc, lx0 = sample_block_general(
        gen, K, 3, me=1, ni=2, p=2, mc=1, dtype=torch.float32,
        device=device, nonlinear_cc=False)
    fn = make_block_solver(lspec, mesh, cfg, device=device)
    lres = fn(lx0, lth, lcc)
    out.append(f"linear-coupling block NLP (fused border): "
               f"signal={int(lres.signal)}, kkt={lres.kkt.cpu().numpy()}, "
               f"{fn.reducer.total} all-reduces in "
               f"{int(lres.iter_count)} iterations")
    assert int(lres.signal) in (1, 2)
    if dist.rank() == 0:
        print("\n".join(out))
    dist.shutdown()
    return res, gres, lres


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    a = ap.parse_args()
    main(device=a.device, backend=a.backend)
