"""Two features of the block-separable solver in one walkthrough:

1. **Per-block L-BFGS** (``IPMConfig(lbfgs=m)``): each block's d^3
   factorization gives way to a compact Woodbury operator of its own
   L-BFGS memory, so blocks far past the dense size solve without ever
   forming a (d, d) matrix.  Here diagonal quadratic blocks with bounds
   and linear coupling, d = 512 a block by default.

2. **Ragged blocks**: per-block constraint counts (me_k, ni_k) under
   fixed maxima and validity masks (``BlockNLP(ce_mask_key=...,
   ci_mask_key=...)``): one solve over unequal blocks.

    python -m pyipm_tpu_torch.examples.block_lbfgs_and_ragged [--device cpu]
"""

import argparse

import torch

from pyipm_tpu_torch import IPMConfig
from pyipm_tpu_torch.parallel.schur import (
    make_block_solver, sample_block_box_quadratic, sample_block_ragged,
)


def main(device="cuda", K=8, d=512, p=4, seed=3):
    gen = torch.Generator(device=device).manual_seed(seed)

    # ---- 1. per-block L-BFGS: large diagonal-quadratic blocks ----------
    spec, theta, ccdata, x0 = sample_block_box_quadratic(
        gen, K, d, p, dtype=torch.float32, device=device)
    cfg = IPMConfig(float_dtype="float32", verbosity=0, lbfgs=8, niter=20,
                    miter=60)
    res = make_block_solver(spec, None, cfg, device=device)(x0, theta,
                                                            ccdata)
    assert int(res.signal) in (1, 2), res.kkt
    print(f"L-BFGS block solve: {K * d} variables (d={d} a block), "
          f"signal={int(res.signal)}, iterations={int(res.iter_count)}, "
          f"kkt={res.kkt.cpu().numpy()}")

    # ---- 2. ragged blocks: unequal (me_k, ni_k) in one solve -----------
    rspec, rtheta, rccdata, rx0, me_k, ni_k = sample_block_ragged(
        gen, 8, d=4, me=2, ni=3, p=2, mc=1, dtype=torch.float32,
        device=device)
    rres = make_block_solver(rspec, None,
                             IPMConfig(float_dtype="float32", verbosity=0),
                             device=device)(rx0, rtheta, rccdata)
    assert int(rres.signal) in (1, 2), rres.kkt
    # the inactive rows' multipliers stay exactly 0
    assert bool(torch.all(rres.le[rtheta["ce_mask"] == 0] == 0.0))
    assert bool(torch.all(rres.li[rtheta["ci_mask"] == 0] == 0.0))
    print(f"ragged block solve: me_k={me_k.tolist()}, "
          f"ni_k={ni_k.tolist()}, signal={int(rres.signal)}, "
          f"iterations={int(rres.iter_count)}")
    print("OK")
    return res, rres


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--d", type=int, default=512)
    a = ap.parse_args()
    main(device=a.device, d=a.d)
