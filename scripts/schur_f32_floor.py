"""How far float32 arithmetic can resolve the Schur solver's stationarity
norm on a separable instance: solve in float32, then evaluate the KKT
norms of the final iterate twice, in float32 and in float64 (the iterate
and the data cast up), and print both with the norm of the difference of
the two gradients of the Lagrangian (the float32 evaluation's own error).

    python scripts/schur_f32_floor.py [--K 4096] [--d 256] [--mc 8]
        [--device cuda] [--package port|both] [--seed 7] [--cell NAME]

``--package port`` draws ``sample_separable``'s instance from a generator
seeded with ``chip_smoke.SEED`` on the device and solves it with the
port; with ``--cell`` (``schur_weak``, ``schur_large`` or ``schur_ranks``)
it solves that cell of ``chip_smoke.BLOCK_CELLS`` instead, drawn by
``sample_separable_arrays`` in the cell's configuration.  ``--package
both`` (CPU only, needs JAX) draws the
instance with the JAX package's sampler (``jax.random.key(seed)``, as
``benchmarks/bench_schur_scaling.py --mode million`` does), solves it in
float32 with both packages, and evaluates both final iterates, and the
port's iterate at the JAX package's last iteration, the same way with the
port's residuals.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from chip_smoke import SEED  # noqa: E402
from pyipm_tpu_torch import IPMConfig  # noqa: E402
from pyipm_tpu_torch.parallel import schur as S  # noqa: E402


def evaluate(fn, fn64, theta, cc, res):
    """(float32 KKT norms, float64 KKT norms, ||rx32 - rx64||_2) of a
    ``SeparableResult``/``BlockResult``-like final iterate."""
    out = []
    rx = []
    for f in (fn, fn64):
        th, c = f.local_data(theta, cc)
        t = f.ops.dtype
        args = [torch.as_tensor(v, device=f.ops.device).to(t)
                for v in (res["x"], res["s"], res["sc"], res["le"],
                          res["li"], res["lc"], res["lci"])]
        mu = torch.as_tensor(res["mu"], device=f.ops.device).to(t)
        kkt, _ = f.ops.kkt_norms(*args, th, c, mu)
        r = f.ops.residual_blocks(*args, th, c, mu)
        out.append(kkt.double().cpu().numpy())
        rx.append(r[0].double())
    return out[0], out[1], float(torch.linalg.vector_norm(rx[0] - rx[1]))


def port_solve(spec, theta, cc, x0, cfg, dev):
    fn = S.make_block_solver(S.separable_block_spec(spec), None, cfg,
                             device=dev)
    fn64 = S.make_block_solver(S.separable_block_spec(spec), None,
                               cfg.replace(float_dtype="float64"), device=dev)
    t = time.perf_counter()
    r = fn(x0, theta, cc)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    res = dict(x=r.x, s=r.s, sc=r.sc, le=r.le, li=r.li, lc=r.lc, lci=r.lci,
               mu=r.mu)
    return fn, fn64, res, int(r.signal), int(r.iter_count), wall


def report(what, sig, its, wall, k32, k64, drx, ktol):
    print(f"{what}: signal {sig} iterations {its} wall {wall:.3f} s\n"
          f"  kkt in float32 {np.array2string(k32, precision=4)}\n"
          f"  the same iterate in float64 "
          f"{np.array2string(k64, precision=4)}\n"
          f"  ||dL/dx(float32) - dL/dx(float64)||_2 = {drx:.4e} "
          f"({drx / ktol:.3f} Ktol)", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--K", type=int, default=4096)
    ap.add_argument("--d", type=int, default=256)
    ap.add_argument("--mc", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--package", default="port", choices=("port", "both"))
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--cell", choices=[c for c, v in cs.BLOCK_CELLS.items()
                                       if v["family"] == "separable"])
    a = ap.parse_args()
    if a.cell and a.package == "both":
        ap.error("--cell draws the port's numpy cell: --package port only")
    dev = torch.device(a.device)
    cfg = IPMConfig(float_dtype="float32", verbosity=0)
    if a.cell:
        cfg = IPMConfig(**cs.BLOCK_CELLS[a.cell]["config"])
        a.K, a.d, a.mc = (cs.BLOCK_CELLS[a.cell]["instance"][k]
                          for k in ("K", "d", "mc"))
    print(f"K={a.K} d={a.d} mc={a.mc} ({a.K * a.d} variables), float32, "
          f"Ktol {cfg.Ktol}, {dev}", flush=True)
    if a.package == "port":
        if a.cell:
            spec = S.separable_spec(a.d, a.mc)
            _, theta, cc, x0 = cs.block_problem(a.cell,
                                                cs.draw_block(a.cell), dev)
        else:
            gen = torch.Generator(device=dev).manual_seed(SEED)
            spec, data, x0 = S.sample_separable(gen, a.K, a.d, a.mc,
                                                device=dev)
            theta = {"user": data.theta, "A": data.A, "lb": data.lb}
            cc = {"b": data.b}
        fn, fn64, res, sig, its, wall = port_solve(spec, theta, cc, x0, cfg,
                                                   dev)
        report("port", sig, its, wall, *evaluate(fn, fn64, theta, cc, res),
               cfg.Ktol)
        return
    import jax
    jax.config.update("jax_platforms", "cpu")
    from pyipm_tpu.config import IPMConfig as JCfg
    from pyipm_tpu.parallel import schur as JS
    from pyipm_tpu_torch import interop

    jspec, jdata, jx0 = JS.sample_separable(jax.random.key(a.seed), a.K, a.d,
                                            a.mc)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("model",))
    jfn = JS.make_separable_solver(jspec, mesh,
                                   JCfg(float_dtype="float32", verbosity=0))
    t = time.perf_counter()
    jr = jfn(jx0, jdata)
    jr.x.block_until_ready()
    jwall = time.perf_counter() - t
    data = interop.separable_data_from_numpy(jdata, device=dev)
    theta = {"user": data.theta, "A": data.A, "lb": data.lb}
    cc = {"b": data.b}
    spec = S.separable_spec(a.d, a.mc)
    tx0 = torch.tensor(np.asarray(jx0), device=dev)
    fn, fn64, res, sig, its, wall = port_solve(spec, theta, cc, tx0, cfg,
                                               dev)
    report("port", sig, its, wall, *evaluate(fn, fn64, theta, cc, res),
           cfg.Ktol)
    # the separable form's only block inequalities are the box: li = z
    jres = dict(x=np.array(jr.x), s=np.array(jr.s),
                sc=np.zeros(0, np.float32), le=np.array(jr.le),
                li=np.array(jr.z), lc=np.array(jr.lc),
                lci=np.zeros(0, np.float32), mu=np.array(jr.mu))
    jits = int(jr.iter_count)
    report("JAX package (the same instance, CPU)", int(jr.signal), jits,
           jwall, *evaluate(fn, fn64, theta, cc, jres), cfg.Ktol)
    print(f"  the JAX package's own float32 kkt "
          f"{np.array2string(np.asarray(jr.kkt), precision=4)}", flush=True)
    # the port paused where the JAX package stopped: the same iterate?
    st = fn.run_budget(fn.init_state(tx0, theta, cc), theta, cc, jits)
    r = fn.finalize(st, theta, cc)
    at = dict(x=r.x, s=r.s, sc=r.sc, le=r.le, li=r.li, lc=r.lc, lci=r.lci,
              mu=r.mu)
    report(f"port paused at iteration {jits}", int(r.signal),
           int(r.iter_count), 0.0, *evaluate(fn, fn64, theta, cc, at),
           cfg.Ktol)
    for what, x in (("paused at the same iteration", at["x"]),
                    ("at its end", res["x"])):
        dx = float(np.max(np.abs(x.cpu().numpy() - jres["x"]))
                   / (1 + np.max(np.abs(jres["x"]))))
        print(f"max |x_port - x_jax| / (1 + max |x_jax|), port {what}: "
              f"{dx:.3e}", flush=True)


if __name__ == "__main__":
    main()
