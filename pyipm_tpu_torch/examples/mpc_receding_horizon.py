"""Receding-horizon MPC with warm starts: the serving pattern.

A controller re-solves the same finite-horizon program every tick with a
shifted initial state.  The warm-start surface of the reference
(x0/s0/lda0, pyipm.py:1567-1578) is what such a loop needs: seed each
tick with the previous solution shifted by one step.  One Problem serves
every tick (the state is data, ``params``), and warm starts cut the
iterations per tick against cold starts.

    python -m pyipm_tpu_torch.examples.mpc_receding_horizon [--device cpu]
"""

import argparse

import numpy as np
import torch

from pyipm_tpu_torch import IPMConfig, solve
from pyipm_tpu_torch.models.applications import (
    make_mpc_problem, mpc_data, sample_mpc_arrays,
)


def main(nx=4, nu=2, T=12, ticks=20, device="cuda"):
    arrays = {k: v[0] for k, v in sample_mpc_arrays(0, 1, nx, nu).items()}
    data0 = mpc_data(arrays, device=device)
    cfg = IPMConfig(float_dtype="float32", verbosity=0, Ktol=1e-4)
    prob = make_mpc_problem(T, nu)

    def tick(x_init, u0, s0=None, lda0=None):
        return solve(prob, u0, cfg, s0=s0, lda0=lda0,
                     params=data0._replace(x_init=x_init))

    def shift(u_flat):
        u = u_flat.reshape(T, nu)
        return torch.cat([u[1:], u[-1:]]).reshape(-1)

    x = data0.x_init
    zeros = torch.zeros(T * nu, device=x.device)
    res = tick(x, zeros)
    cold_iters, warm_iters = [int(res.iter_count)], []
    for _ in range(ticks):
        # apply the first input, step the plant, re-solve warm: the slack
        # re-derived from ci at the shifted inputs, the multipliers reused
        x = data0.Ad @ x + data0.Bd @ res.x.reshape(T, nu)[0]
        u_ws = shift(res.x)
        s_ws = torch.clamp(torch.cat([u_ws + data0.umax, data0.umax - u_ws]),
                           min=cfg.Ktol)
        res_w = tick(x, u_ws, s_ws, res.lda)
        res_c = tick(x, zeros)
        warm_iters.append(int(res_w.iter_count))
        cold_iters.append(int(res_c.iter_count))
        assert int(res_w.signal) in (1, 2)
        res = res_w

    print(f"cold-start iterations/tick: mean {np.mean(cold_iters):.1f}")
    print(f"warm-start iterations/tick: mean {np.mean(warm_iters):.1f}")
    assert np.mean(warm_iters) < np.mean(cold_iters)
    print("warm starts save "
          f"{100 * (1 - np.mean(warm_iters) / np.mean(cold_iters)):.0f}%"
          " of iterations in the receding-horizon loop")
    return cold_iters, warm_iters


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    main(device=ap.parse_args().device)
