"""Digests of the fleets' results of one checkout on the card, so that two
trees can be held to each other bit for bit.

    python scripts/fleet_digests.py [--root DIR]

Imports ``pyipm_tpu_torch`` from ``--root`` (default: this checkout) and
runs, with this checkout's ``chip_smoke`` code, phase 4's 10,000-QP fleet
(``solve_batch``, float32, x0 from numpy seed 7 after a warm-up) and phase
16 (``mixed_fleet_phase``: each bucket alone through ``solve_fleet``, then
every bucket and problem 5 in one call, with its checks), then phase 22
(``separable_phase`` of the ``schur_large`` cell: the Schur solver's 256
blocks of d = 1024 in float32, the batched kernel 3's path, held to the
JAX package's answer).  Prints the first 16 hex
digits of the sha256 of each run's signals, iteration counts and x, and
the kernels' launches by n (by B for kernel 3); run it on a parent unpacked
with ``git archive`` and on this tree in one call.  Needs one CUDA card.
"""

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fleet_digests: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from pyipm_tpu_torch import IPMConfig, _sync, solve_batch
    from pyipm_tpu_torch.ops import large_ldlt as ll
    from pyipm_tpu_torch.ops import small_ldlt as sl
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}; package {os.path.dirname(sl.__file__)}", flush=True)
    device = torch.device("cuda:0")
    cfg = IPMConfig(float_dtype="float32", verbosity=0, Ktol=1e-4)
    counters = (sl.LAUNCHES, sl.LAUNCHES_BY_N, ll.LAUNCHES, _sync.COUNTS)
    problem, data, x0 = cs.qp_fleet(cfg, device)
    res, _ = cs.timed(lambda: solve_batch(problem, x0, cfg, params=data),
                      counters)
    print(f"10k-QP fleet digests: "
          f"{cs.digests(res.signal, res.iter_count, res.x)}, kernel 1-2 "
          f"launches by n {cs.by_n(sl)}", flush=True)
    del res, data
    mixed = cs.mixed_fleet_phase(cfg, device, counters, sl, ll, _sync)
    for name, rec in mixed.items():
        print(f"mixed fleet {name}: digests {rec['digests']}, kernel 1-2 "
              f"launches by n {rec['launches_by_n']}", flush=True)
    from pyipm_tpu_torch.config import matmul_precision
    from pyipm_tpu_torch.parallel import schur as S
    with matmul_precision(cfg.matmul_precision):
        large = cs.separable_phase(
            S, "schur_large",
            counters[:3] + (ll.LAUNCHES_BY_B, _sync.COUNTS), sl, ll, _sync,
            device, need_k3=True)
    print(f"Schur K={cs.LARGE['K']} d={cs.LARGE['d']}: digests "
          f"{large['digests']}, kernel 3 launches by B "
          f"{large['kernel3_by_b']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
