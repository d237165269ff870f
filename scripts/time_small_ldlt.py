"""Time the batched small LDL^T factor (kernel 1) of one checkout on the card.

    python scripts/time_small_ldlt.py [--root DIR]

Imports ``pyipm_tpu_torch`` from ``--root`` (default: this checkout), so
that two trees, say a parent unpacked with ``git archive`` and this one, are
timed in one call by the same code: ``chip_smoke.factor_timings`` at each
f32 shape of ``chip_smoke.TIMED_SHAPES``, ``FACTOR_ONLY_SHAPE`` and
``WIDE_SHAPES`` ((10000, 16), (10000, 36), (512, 128), and phase 16's
(2048, n) at n = 65, 67, 80, 96, 97), on inputs drawn from its ``SEED``.
Prints the card's name and power limit first.
Needs one CUDA card.
"""

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

from chip_smoke import (  # noqa: E402
    FACTOR_ONLY_SHAPE, SEED, TIMED_SHAPES, WIDE_SHAPES, factor_timings,
    rand_sym,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_small_ldlt: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from pyipm_tpu_torch.ops import small_ldlt as sl
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}; package {os.path.dirname(sl.__file__)}", flush=True)
    dev = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(SEED)
    for Bn, n in TIMED_SHAPES + (FACTOR_ONLY_SHAPE,) + WIDE_SHAPES:
        A = rand_sym(gen, Bn, n, torch.float32, dev)
        t = factor_timings(sl, A, plain_reps=3)
        dms, how, per_call = t["factor_device"]
        b_ms, b_by = t["factor_bound"]
        print(f"factor f32 B={Bn} n={n}: {t['factor']:.4f} ms per call, "
              f"device {dms:.4f} ms per launch ({how}, {per_call} launches "
              f"per call seen), the wrapper at B=1 {t['factor_floor']:.4f} "
              f"ms, plain {t['factor_plain']:.4f} ms, bound {b_ms:.5f} ms by "
              f"{b_by}, device/bound {dms / b_ms:.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
