"""Pause a solve, save its state, restore it as a new process would, and
finish: the result equals the solve that never stopped.

First a single reference problem through the batch solver, then the
block-separable Schur solver, whose state (each rank's blocks) is the
same kind of checkpoint unit.

    python -m pyipm_tpu_torch.examples.checkpoint_resume --device cpu
"""

import argparse
import os
import tempfile

import numpy as np
import torch

from pyipm_tpu_torch import IPMConfig, make_solver
from pyipm_tpu_torch.models.reference_problems import get_problem
from pyipm_tpu_torch.parallel.schur import (
    make_block_solver, sample_block_general,
)
from pyipm_tpu_torch.utils.checkpoint import restore_state, save_state


def main(device="cuda"):
    prob = get_problem(10).make()             # mixed eq + ineq problem
    solver = make_solver(prob, IPMConfig(verbosity=0))
    x0 = torch.zeros((1, 3), dtype=torch.float64, device=device)
    full = solver.finalize(solver.run(solver.init_state(x0)))
    st = solver.run_budget(solver.init_state(x0), 3)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt")
        save_state(path, st)
        st2 = restore_state(path, solver.init_state(x0))
        res = solver.finalize(solver.run(st2))
    print("resumed  x =", res.x[0].cpu().numpy(), "signal",
          int(res.signal[0]))
    print("straight x =", full.x[0].cpu().numpy(), "signal",
          int(full.signal[0]))
    assert torch.equal(res.x, full.x)
    assert int(res.iter_count[0]) == int(full.iter_count[0])

    # the block solver: run_budget, save, restore, run
    gen = torch.Generator(device=device).manual_seed(3)
    spec, theta, cc, bx0 = sample_block_general(gen, 8, 3, me=1, ni=2, p=2,
                                                mc=1, device=device)
    fn = make_block_solver(spec, None, IPMConfig(float_dtype="float64",
                                                 verbosity=0),
                           device=device)
    bfull = fn(bx0, theta, cc)
    bst = fn.run_budget(fn.init_state(bx0, theta, cc), theta, cc,
                        max_new_iters=3)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "block")
        save_state(path, bst)
        bst2 = restore_state(path, fn.init_state(bx0, theta, cc))
    bres = fn.finalize(fn.run(bst2, theta, cc), theta, cc)
    assert torch.equal(bres.x, bfull.x)
    assert int(bres.iter_count) == int(bfull.iter_count)
    print("block solve resumed bit for bit:", int(bres.iter_count),
          "iterations, signal", int(bres.signal),
          "max |x|", float(np.abs(bres.x.cpu().numpy()).max()))
    return res, bres


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    main(device=ap.parse_args().device)
