"""Time phases 21-25 of one checkout's ``chip_smoke.py`` on the card, each
phase whole (its draws, solves, holds and checks), and on a tree with the
numpy-drawn Schur cells also each cell's host draw and digest.

    python scripts/time_schur_phases.py [--root DIR]

Imports ``chip_smoke`` and ``pyipm_tpu_torch`` from ``--root`` (default:
this checkout), builds its kernels, runs the phases in order and prints
one ``PHASE_TIMES`` line of seconds.  A tree from before the numpy cells
(89879e9 and older) is called with its own phase signatures.  To compare
two trees, unpack the other with ``git archive`` into a git-ignored
directory and run parent, change, change, parent in one call.  Needs one
CUDA card.
"""

import argparse
import inspect
import json
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    root = ap.parse_args().root
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import chip_smoke as cs
    from pyipm_tpu_torch import IPMConfig, _sync
    from pyipm_tpu_torch.models import applications as A
    from pyipm_tpu_torch.ops import _build
    from pyipm_tpu_torch.ops import large_ldlt as ll
    from pyipm_tpu_torch.ops import small_ldlt as sl
    from pyipm_tpu_torch.parallel import schur as S

    _build.build(force=True, verbose=False)
    _build.load()
    dev = torch.device("cuda:0")
    counters = (sl.LAUNCHES, sl.LAUNCHES_BY_N, ll.LAUNCHES,
                ll.LAUNCHES_BY_B, _sync.COUNTS)
    times = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        fn()
        times[name] = round(time.perf_counter() - t0, 3)

    args = (counters, sl, ll, _sync, dev)
    if "cell" in inspect.signature(cs.separable_phase).parameters:
        timed("21", lambda: cs.separable_phase(S, "schur_weak", *args,
                                               need_k1=True))
        timed("22", lambda: cs.separable_phase(S, "schur_large", *args,
                                               need_k3=True))
        timed("23", lambda: cs.general_phase(S, *args))
        timed("24", lambda: cs.ranks_phase(S, dev))
    else:
        cfg = IPMConfig(float_dtype="float32", verbosity=0, Ktol=1e-4)
        timed("21", lambda: cs.separable_phase(
            S, cfg.replace(schur_refine_steps=0, schur_refine_guard=False),
            cs.WEAK, *args, need_k1=True))
        timed("22", lambda: cs.separable_phase(S, cfg, cs.LARGE, *args,
                                               need_k3=True))
        timed("23", lambda: cs.general_phase(S, A, cfg, *args))
        timed("24", lambda: cs.ranks_phase(S, cfg, dev))
    timed("25", lambda: cs.lbfgs_block_phase(S, *args))
    for cell in getattr(cs, "BLOCK_CELLS", ()):
        timed(f"draw {cell}",
              lambda: cs.input_digests(cs.draw_block(cell)))
    print("PHASE_TIMES", root, json.dumps(times), flush=True)


if __name__ == "__main__":
    main()
