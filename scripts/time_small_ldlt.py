"""Time the batched small LDL^T factor (kernel 1), the solve (kernel 2) and
the panel factor (kernel 3) of one checkout on the card.

    python scripts/time_small_ldlt.py [--root DIR] [--kernels factor solve
        panel] [--no-library] [--save F.pt | --compare F.pt]

Imports ``pyipm_tpu_torch`` from ``--root`` (default: this checkout), so
that two trees, say a parent unpacked with ``git archive`` and this one, are
timed in one call by the same code.  ``factor`` (the default with
``solve``): ``chip_smoke.factor_timings`` at each f32 shape of
``chip_smoke.TIMED_SHAPES``, ``FACTOR_ONLY_SHAPE`` and ``WIDE_SHAPES``
((10000, 16), (10000, 36), (512, 128), and phase 16's (2048, n) at n = 65,
67, 80, 96, 97), and the f64 factor at (512, 128), on inputs drawn from its
``SEED``.  ``solve``: the solve at (10000, 16), (10000, 36) and at (2048, n)
for n = 40, 65, 67, 80, 96, 97, 128 (phase 16's sizes and the wide
kernel's bucket edges): ms per call, device ms per launch, the plain
version, ``torch.linalg.ldl_solve`` with identity pivots (one call after a
warm-up; skipped with ``--no-library``) and ``chip_smoke.solve_bound``.
``panel``: the panel factor on one (128, 128) panel and on phase 19's
(256, 128, 128) batch: ms per call, device ms per launch, the plain version
and the bound.  The solve's and the panel's inputs are drawn per shape from
a seed of their own, so ``--save`` (the outputs to a file) on one tree and
``--compare`` (the outputs against that file, bit for bit) on another hold
the two trees' kernels to each other on the same inputs.
Prints the card's name and power limit first.  Needs one CUDA card.
"""

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

from chip_smoke import (  # noqa: E402
    FACTOR_ONLY_SHAPE, LARGE, PATH_B, REPS, SEED, TIMED_SHAPES, WIDE_SHAPES,
    cuda_ms, device_ms, factor_bound, factor_timings, library_ms, rand_sym,
    same_bits, solve_bound,
)

# the sizes the solve is timed at: phase 3's, phase 16's (n = 40 to 97) and
# the wide solve's bucket edges (96, 128)
SOLVE_SHAPES = TIMED_SHAPES + tuple(
    (PATH_B, n) for n in (40, 65, 67, 80, 96, 97, 128))
PANEL_SHAPES = ((1, 128), (LARGE["K"], 128))


def report_factor(what, Bn, n, t, b_ms, b_by):
    dms, how, per_call = t["factor_device"]
    print(f"factor {what} B={Bn} n={n}: {t['factor']:.4f} ms per call, "
          f"device {dms:.4f} ms per launch ({how}, {per_call} launches "
          f"per call seen), the wrapper at B=1 {t['factor_floor']:.4f} "
          f"ms, plain {t['factor_plain']:.4f} ms, bound {b_ms:.5f} ms by "
          f"{b_by}, device/bound {dms / b_ms:.2f}", flush=True)


def factor_rows(sl, dev):
    gen = torch.Generator().manual_seed(SEED)
    for Bn, n in TIMED_SHAPES + (FACTOR_ONLY_SHAPE,) + WIDE_SHAPES:
        A = rand_sym(gen, Bn, n, torch.float32, dev)
        t = factor_timings(sl, A, plain_reps=3)
        report_factor("f32", Bn, n, t, *t["factor_bound"])
    # the f64 wide branch (8 warps an instance): bytes of 8, the f64 peak
    Bn, n = FACTOR_ONLY_SHAPE
    t = factor_timings(sl, rand_sym(gen, Bn, n, torch.float64, dev),
                       plain_reps=3)
    report_factor("f64", Bn, n, t, *t["factor_bound"])


def solve_rows(sl, dev, library, outputs):
    for Bn, n in SOLVE_SHAPES:
        gen = torch.Generator().manual_seed(SEED + n)
        A = rand_sym(gen, Bn, n, torch.float32, dev)
        b = torch.randn(Bn, n, generator=gen).to(dev)
        L, d = sl.ldlt_factor_small_ref(A)
        lib = None
        if library:
            LD = torch.tril(L, -1) + torch.diag_embed(d)
            piv = torch.arange(1, n + 1, dtype=torch.int32,
                               device=dev).expand(Bn, n).contiguous()
            lib, _ = library_ms(lambda: torch.linalg.ldl_solve(
                LD, piv, b[..., None]), "torch.linalg.ldl_solve")
        outputs[f"solve_{Bn}x{n}"] = sl.ldlt_solve_small(L, d, b)
        ms = cuda_ms(lambda: sl.ldlt_solve_small(L, d, b), REPS)
        dms, how, per_call = device_ms(lambda: sl.ldlt_solve_small(L, d, b),
                                       ("ldlt_solve_kernel",))
        plain = cuda_ms(lambda: sl.ldlt_solve_small_ref(L, d, b), 3)
        b_ms, b_by = solve_bound(Bn, n)
        print(f"solve f32 B={Bn} n={n}: {ms:.4f} ms per call, device "
              f"{dms:.4f} ms per launch ({how}, {per_call} launches per "
              f"call seen), plain {plain:.4f} ms, ldl_solve {lib} ms, bound "
              f"{b_ms:.5f} ms by {b_by}, device/bound {dms / b_ms:.2f}",
              flush=True)


def panel_rows(ll, dev, outputs):
    gen = torch.Generator().manual_seed(7)
    P = rand_sym(gen, LARGE["K"], 128, torch.float32, dev)
    for Bn, n in PANEL_SHAPES:
        A = P[0] if Bn == 1 else P
        outputs[f"panel_{Bn}x{n}"] = torch.cat(
            [t.reshape(-1) for t in ll.panel_ldlt(A)])
        ms = cuda_ms(lambda: ll.panel_ldlt(A), REPS)
        dms, how, per_call = device_ms(lambda: ll.panel_ldlt(A),
                                       ("panel_ldlt_kernel",))
        plain = cuda_ms(lambda: ll.panel_ldlt_ref(A), 3)
        b_ms, b_by = factor_bound(Bn, n)
        print(f"panel f32 B={Bn} n={n}: {ms:.4f} ms per call, device "
              f"{dms:.4f} ms per launch ({how}, {per_call} launches per "
              f"call seen), plain {plain:.4f} ms, bound {b_ms:.5f} ms by "
              f"{b_by}, device/bound {dms / b_ms:.2f}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--kernels", nargs="+", default=["factor", "solve"],
                    choices=["factor", "solve", "panel"])
    ap.add_argument("--no-library", action="store_true")
    io = ap.add_mutually_exclusive_group()
    io.add_argument("--save")
    io.add_argument("--compare")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_small_ldlt: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from pyipm_tpu_torch.ops import large_ldlt as ll
    from pyipm_tpu_torch.ops import small_ldlt as sl
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}; package {os.path.dirname(sl.__file__)}", flush=True)
    dev = torch.device("cuda:0")
    outputs = {}
    if "factor" in args.kernels:
        factor_rows(sl, dev)
    if "solve" in args.kernels:
        solve_rows(sl, dev, not args.no_library, outputs)
    if "panel" in args.kernels:
        panel_rows(ll, dev, outputs)
    outputs = {k: v.cpu() for k, v in outputs.items()}
    if args.save:
        torch.save(outputs, args.save)
    if args.compare:
        ref = torch.load(args.compare)
        for k, v in outputs.items():
            same = k in ref and same_bits(v, ref[k])
            print(f"{k}: {'bitwise equal to' if same else 'DIFFERS from'} "
                  f"{args.compare}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
