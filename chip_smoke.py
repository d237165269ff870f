"""Drive the PyTorch/CUDA port once on the card, end to end.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: compile the hand-written kernels from pyipm_tpu_torch/csrc;
  3. kernels against their plain PyTorch versions on the card, f32 and f64;
  4. the slice: the 10,000-QP float32 fleet through ``solve_batch`` on
     cuda:0, launch counters reset just before the timed solve;
  5. the same first 64 instances on CPU tensors (the plain path) against
     the card's results.
The line before the last is the kernels' JSON record; the last line is
the JSON result.  Needs one CUDA card and the repository checkout.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED, B, D, NLIN = 42, 10_000, 16, 4
N_CROSS = 64
KERNEL_SHAPES = ((10_000, 16), (10_000, 36), (129, 36), (1, 16), (512, 128))
TIMED_SHAPES = ((10_000, 16), (10_000, 36))


def phase(name):
    print(f"== {name}", flush=True)


def rand_sym(gen, Bn, n, dtype, device):
    """Random symmetric matrices with diagonal shift n/4 (as the JAX
    package's kernel tests), every 7th made indefinite with a dominant
    diagonal of alternating sign so its pivots stay well away from 0."""
    A = torch.randn(Bn, n, n, generator=gen, dtype=torch.float64)
    A = (A + A.transpose(1, 2)) / 2
    sgn = torch.where(torch.arange(n) % 2 == 0, 1.0, -1.0).to(torch.float64)
    A_pd = A + torch.eye(n, dtype=torch.float64) * (n / 4)
    A_ind = 0.5 * A + torch.diag(sgn * n)
    pick = (torch.arange(Bn) % 7 == 3)[:, None, None]
    return torch.where(pick, A_ind, A_pd).to(dtype).to(device)


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def check_kernels(sl, device):
    """Phase 3; returns per-kernel error and timing records."""
    gen = torch.Generator().manual_seed(SEED)
    err = {"factor": 0.0, "solve": 0.0}
    for dtype in (torch.float32, torch.float64):
        for Bn, n in KERNEL_SHAPES:
            A = rand_sym(gen, Bn, n, dtype, device)
            b = torch.randn(Bn, n, generator=gen,
                            dtype=torch.float64).to(dtype).to(device)
            L, d = sl.ldlt_factor_small(A)
            Lr, dr = sl.ldlt_factor_small_ref(A)
            x = sl.ldlt_solve_small(Lr, dr, b)
            xr = sl.ldlt_solve_small_ref(Lr, dr, b)
            torch.cuda.synchronize()
            if not torch.equal(d < 0, dr < 0):
                raise AssertionError(f"pivot signs differ at {(Bn, n)} {dtype}")
            # reconstruction, against the backward-error bound of unpivoted
            # LDL^T, which scales with |L||D||L^T| (= max|A| when no pivot
            # is small; a few of 10,000 random instances have one)
            Ld, dd = L.double(), d.double()
            rec = (Ld * dd[:, None, :]) @ Ld.transpose(1, 2)
            growth = (Ld.abs() * dd.abs()[:, None, :]) @ Ld.abs().transpose(1, 2)
            scale = torch.maximum(A.double().abs().amax(dim=(1, 2)),
                                  growth.amax(dim=(1, 2)))
            rec_tol = (5e-5 if dtype == torch.float32 else 1e-12) * n
            rec_err = ((rec - A.double()).abs().amax(dim=(1, 2)) / scale).max()
            if float(rec_err) > rec_tol:
                raise AssertionError(f"reconstruction error {float(rec_err)} "
                                     f"> {rec_tol} at {(Bn, n)} {dtype}")
            if dtype == torch.float32:
                torch.testing.assert_close(d, dr, rtol=5e-3, atol=1e-3)
                torch.testing.assert_close(x, xr, rtol=2e-3, atol=6e-3)
            else:
                torch.testing.assert_close(d, dr, rtol=1e-10, atol=1e-10)
                torch.testing.assert_close(
                    x, xr, rtol=1e-10, atol=1e-10 * float(xr.abs().max()))
            if dtype == torch.float32 and (Bn, n) in TIMED_SHAPES:
                err["factor"] = max(err["factor"],
                                    float((L - Lr).abs().max()),
                                    float((d - dr).abs().max()))
                err["solve"] = max(err["solve"], float((x - xr).abs().max()))
            print(f"  ok {str(dtype):14s} B={Bn:5d} n={n:3d}  "
                  f"max|d-dref|={float((d - dr).abs().max()):.3e}  "
                  f"max|x-xref|={float((x - xr).abs().max()):.3e}",
                  flush=True)

    times = {}
    for Bn, n in TIMED_SHAPES:
        A = rand_sym(gen, Bn, n, torch.float32, device)
        b = torch.randn(Bn, n, generator=gen).to(device)
        L, d = sl.ldlt_factor_small(A)
        times[n] = dict(
            factor=cuda_ms(lambda: sl.ldlt_factor_small(A), 50),
            factor_plain=cuda_ms(lambda: sl.ldlt_factor_small_ref(A), 10),
            solve=cuda_ms(lambda: sl.ldlt_solve_small(L, d, b), 50),
            solve_plain=cuda_ms(lambda: sl.ldlt_solve_small_ref(L, d, b), 10))
        t = times[n]
        print(f"  f32 B={Bn} n={n}: factor {t['factor']:.4f} ms "
              f"(plain {t['factor_plain']:.4f} ms), solve {t['solve']:.4f} ms "
              f"(plain {t['solve_plain']:.4f} ms), CUDA events, median",
              flush=True)
    return err, times


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        return 1
    from pyipm_tpu_torch import IPMConfig, _sync, solve_batch
    from pyipm_tpu_torch.models.random_nlp import (
        make_qp_problem, sample_qp_batch,
    )
    from pyipm_tpu_torch.ops import _build, small_ldlt as sl

    device = torch.device("cuda:0")

    phase("1 device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, count "
          f"{torch.cuda.device_count()}", flush=True)

    phase("2 build")
    t0 = time.perf_counter()
    path = _build.build(force=True)
    _build.load()
    print(f"  built {path.name} in {time.perf_counter() - t0:.2f} s",
          flush=True)

    phase("3 kernels against their plain versions")
    err, times = check_kernels(sl, device)

    phase("4 the slice: 10,000-QP float32 fleet on cuda:0")
    cfg = IPMConfig(float_dtype="float32", verbosity=0, Ktol=1e-4)
    problem = make_qp_problem(D, NLIN)
    data = sample_qp_batch(SEED, B, D, NLIN, dtype="float32", device=device)
    solve_batch(problem, torch.zeros((B, D), device=device), cfg,
                params=data)                                     # warm-up
    rng = np.random.default_rng(7)
    x0 = torch.as_tensor(1e-6 * rng.standard_normal((B, D)),
                         dtype=torch.float32, device=device)
    torch.cuda.synchronize()
    for counts in (sl.LAUNCHES, _sync.COUNTS):
        for k in counts:
            counts[k] = 0
    t0 = time.perf_counter()
    res = solve_batch(problem, x0, cfg, params=data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(sl.LAUNCHES)
    stats = dict(_sync.COUNTS)
    sig = res.signal.cpu().numpy()
    its = res.iter_count.cpu().numpy()
    hit = float(np.mean(np.isin(sig, (1, 2))))
    total = int(its.sum())
    syncs_per_step = stats["host_syncs"] / max(stats["flat_steps"], 1)
    print(f"  hit_rate={hit:.4f} mean_iters={its.mean():.3f} "
          f"max_iters={int(its.max())} total_iters={total} "
          f"wall_s={wall:.4f} iters_per_s={total / wall:.1f} "
          f"flat_steps={stats['flat_steps']} "
          f"host_syncs_per_step={syncs_per_step:.2f} "
          f"launches_factor={launches['factor']} "
          f"launches_solve={launches['solve']}", flush=True)
    if tuple(res.x.shape) != (B, D) or not bool(torch.isfinite(res.x).all()):
        raise AssertionError("fleet solution is not a finite (B, D) array")
    if hit < 0.99:
        raise AssertionError(f"hit rate {hit} < 0.99")
    conv = torch.as_tensor(np.isin(sig, (1,)), device=device)
    if not bool((res.kkt[conv] <= cfg.Ktol).all()):
        raise AssertionError("a Ktol-converged instance has KKT > Ktol")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel was not launched: {launches}")

    phase(f"5 plain path on CPU, first {N_CROSS} instances")
    data_cpu = type(data)(*(t[:N_CROSS].cpu() for t in data))
    res_cpu = solve_batch(problem, x0[:N_CROSS].cpu(), cfg, params=data_cpu)
    sg, sc = sig[:N_CROSS], res_cpu.signal.numpy()
    ig, ic = its[:N_CROSS], res_cpu.iter_count.numpy()
    xg, xc = res.x[:N_CROSS].cpu().numpy(), res_cpu.x.numpy()
    same_iters = int(np.sum(ig == ic))
    both = np.isin(sg, (1, 2)) & np.isin(sc, (1, 2))
    xerr = np.abs(xg - xc) / (1.0 + np.abs(xc))
    xerr_max = float(xerr[both].max()) if both.any() else 0.0
    print(f"  signals equal {int(np.sum(sg == sc))}/{N_CROSS}, iterations "
          f"equal {same_iters}/{N_CROSS}, max |dx|/(1+|x|) {xerr_max:.3e}",
          flush=True)
    if not np.array_equal(sg, sc):
        raise AssertionError("signals differ between kernel and plain path")
    if same_iters < 58:
        raise AssertionError(f"iteration counts equal on {same_iters} < 58")
    if xerr_max > 1e-3:
        raise AssertionError(f"x differs by {xerr_max} > 1e-3 (1+|x|)")

    record = {"kernels": [
        {"name": "ldlt_factor_small", "route": "cuda",
         "source": "pyipm_tpu_torch/csrc/small_ldlt.cu",
         "replaces": "pyipm_tpu/ops/pallas_ldlt.py:49",
         "launches": launches["factor"], "max_abs_err": err["factor"],
         "ms": times[16]["factor"], "plain_ms": times[16]["factor_plain"],
         "shape": [10_000, 16],
         "ms_n36": times[36]["factor"],
         "plain_ms_n36": times[36]["factor_plain"]},
        {"name": "ldlt_solve_small", "route": "cuda",
         "source": "pyipm_tpu_torch/csrc/small_ldlt.cu",
         "replaces": "pyipm_tpu/ops/pallas_ldlt.py:92",
         "launches": launches["solve"], "max_abs_err": err["solve"],
         "ms": times[16]["solve"], "plain_ms": times[16]["solve_plain"],
         "shape": [10_000, 16],
         "ms_n36": times[36]["solve"],
         "plain_ms_n36": times[36]["solve_plain"]},
    ]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
