"""Time the block-separable Schur solver's pieces on one separable
instance, then whole solves, on the card (or the CPU).

    python scripts/profile_schur.py [--K 4096] [--d 256] [--mc 8]
        [--dtype float32] [--device cuda] [--trace-iters 3]

The instance is ``sample_separable``'s from a generator seeded with
``chip_smoke.SEED`` (phases 21-22 of ``chip_smoke.py`` draw theirs with
``sample_separable_arrays`` instead).  Prints the wall of each piece of
one iteration (the per-block gradient, Jacobian and Hessian, the
least-squares multipliers, ``batched_reg_factor`` and a solve), of three
inner iterations one by one, of one whole solve with its signal,
iterations, KKT norms, host syncs, flat steps and all-reduces, and, with
``--trace-iters N`` (on the card), the device's busy share over the first N inner
iterations under ``torch.profiler``.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from chip_smoke import SEED, busy_share  # noqa: E402
from pyipm_tpu_torch import IPMConfig, _sync  # noqa: E402
from pyipm_tpu_torch.ops import linalg as lin  # noqa: E402
from pyipm_tpu_torch.parallel import schur as S  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--K", type=int, default=4096)
    ap.add_argument("--d", type=int, default=256)
    ap.add_argument("--mc", type=int, default=8)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace-iters", type=int, default=0)
    a = ap.parse_args()
    dev = torch.device(a.device)

    def tm(what, fn):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        print(f"{what}: {time.perf_counter() - t:.4f} s", flush=True)
        return out

    cfg = IPMConfig(float_dtype=a.dtype, verbosity=0)
    dt = cfg.torch_dtype
    gen = torch.Generator(device=dev).manual_seed(SEED)
    spec, data, x0 = S.sample_separable(gen, a.K, a.d, a.mc, dtype=dt,
                                        device=dev)
    fn = S.make_block_solver(S.separable_block_spec(spec), None, cfg,
                             device=dev)
    theta, cc = {"user": data.theta, "A": data.A, "lb": data.lb}, \
        {"b": data.b}
    th, ccl = fn.local_data(theta, cc)
    ops = fn.ops
    le, li = ops.zeros(a.K, 0), ops.zeros(a.K, a.d) + 1
    w = ops.zeros(a.mc)
    tm("gradient (first call, warm-up included)",
       lambda: ops.gradf_v(x0, th))
    tm("gradient", lambda: ops.gradf_v(x0, th))
    tm("coupling Jacobian", lambda: ops.G_v(x0, th))
    W = tm("Hessian", lambda: ops.W_v(x0, th, le, li, w))
    tm("least-squares multipliers",
       lambda: ops.ls_multiplier_init(x0, th, ccl))
    H = W + torch.eye(a.d, dtype=dt, device=dev)
    fac = tm("batched_reg_factor", lambda: lin.batched_reg_factor(
        H, ops.zeros(a.K), torch.tensor(0.1, dtype=dt, device=dev), neq=0,
        eps=cfg.eps, reg_coef=cfg.reg_coef, eta=cfg.eta, beta=cfg.beta,
        delta0=cfg.delta0))
    tm("solve of 8 right-hand sides",
       lambda: fac[0](torch.ones(a.K, a.d, 8, dtype=dt, device=dev)))
    del W, H, fac
    st = tm("init_state", lambda: fn.init_state(x0, theta, cc))
    for i in range(3):
        st = tm(f"inner iteration {i + 1}",
                lambda: fn.run_budget(st, theta, cc, 1))
    _sync.COUNTS.update(host_syncs=0, flat_steps=0)
    calls = fn.reducer.total
    r = tm("whole solve", lambda: fn(x0, theta, cc))
    print(f"signal {int(r.signal)} iterations {int(r.iter_count)} kkt "
          f"{r.kkt.cpu().numpy()} host syncs {_sync.COUNTS['host_syncs']} "
          f"flat steps {_sync.COUNTS['flat_steps']} all-reduces "
          f"{fn.reducer.total - calls}", flush=True)
    if a.trace_iters:
        st0 = fn.init_state(x0, theta, cc)
        _, busy, wall, idle = busy_share(
            lambda: fn.run_budget(st0, theta, cc, a.trace_iters))
        print(f"first {a.trace_iters} inner iterations under the profiler: "
              f"device busy {busy:.1f} ms of {wall:.3f} s, idle "
              f"{100 * idle:.1f}%", flush=True)


if __name__ == "__main__":
    main()
