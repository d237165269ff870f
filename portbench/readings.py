"""The readings a cell's check limits are set from: the program's
numbers over many seeds, and the control's, in one process.

    python3 -m portbench.readings --workload <cell> --seeds 1,2,3
        [--control-seeds 4,5,6] [--witness N]

For each seed the pool is drawn as a run draws it, every call of the pool
is solved once, and the plain reference judges every answer (the largest
value of each number is printed, one JSON line a seed, with the first
answers that pass a limit by call and row).  The control is the
program's own float32 path on the same draw (cast), the nearest
precision below the float64 the configurations state; its lines carry
``"side": "control"``.  With ``--witness N`` the family's second witness
(``witness/<family>.py``) solves up to N of a seed's answers that pass a
limit and N that do not, and each is printed beside the program's
objective.  Runs on the card, or with ``--device cpu``.
"""

import argparse
import json
import math
import sys
import time

import torch

from portbench import harness, registry

SHOWN = 20          # answers past a limit listed a seed


def over_limits(pers: list, answers: list, limits: dict) -> list:
    """[(call, row, {number: value past its limit}, f)] of every answer
    that passes a limit; ``pers`` holds the reference's numbers of each
    answer."""
    out = []
    for per, a in zip(pers, answers):
        per = {k: v.reshape(-1).cpu() for k, v in per.items() if k in limits}
        # NaN passes no limit
        past = {k: ~(v <= limits[k]) for k, v in per.items()}
        fval = a.fval.reshape(-1).cpu()
        rows = torch.stack(list(past.values())).any(0).nonzero()
        for row in rows.reshape(-1).tolist():
            out.append((a.call, row, {k: float(per[k][row]) for k in per
                                      if past[k][row]},
                        float(fval[row])))
    return out


def stationarity_gap(pers: list, answers: list) -> float:
    """The largest gap between the reference's ``stationarity`` and the
    norm the solver's own stopping test read (its first KKT norm): the
    same quantity, computed twice."""
    return max(float(torch.abs(per["stationarity"].reshape(-1)
                               - a.kkt.to(torch.float64).reshape(-1, 4)[:, 0]
                               ).max())
               for per, a in zip(pers, answers))


def witness(c, w, over, n: int, root=registry.ROOT) -> list:
    """The second witness on up to ``n`` answers past a limit and ``n``
    within every limit: the program's f beside the witness's."""
    wit = registry.witness(c.config["family"], root)
    bad = {(call, row) for call, row, _, _ in over}
    picked = [(call, row) for call, row, _, _ in over][:n]
    sound = [(a.call, r) for a in w.answers
             for r in range(a.fval.numel()) if (a.call, r) not in bad][:n]
    out = []
    for call, row in picked + sound:
        a = next(a for a in w.answers if a.call == call)
        params = c.pool[call].params
        if a.fval.dim() == 0:
            params = type(params)(*(t.unsqueeze(0) for t in params))
        opt = wit.optimum(params, row)
        f = float(a.fval.reshape(-1)[row])
        out.append({"call": call, "row": row,
                    "past_a_limit": (call, row) in bad, "f": f,
                    "witness": opt, "f_minus_witness": f - opt["f"]})
    return out


def readings(name: str, seed: int, device, float_dtype=None,
             root=registry.ROOT, n_witness: int = 0) -> dict:
    c = harness.prepare(name, seed, device, root, float_dtype=float_dtype)
    w = harness.Window()
    for k, call in enumerate(c.pool):
        t = time.perf_counter()
        w.answers.append(harness.solve_once(c, call, k))
        harness.sync_device(device)
        w.walls.append(time.perf_counter() - t)
    worst, failed, attempted = harness.judge(c, w, root)
    ref = registry.reference(c.config["family"], root)
    pers = [ref.judge(c.pool[a.call].params, a) for a in w.answers]
    over = over_limits(pers, w.answers, c.spec["limits"])
    out = {"seed": seed, "side": "control" if float_dtype else "program",
           "walls": w.walls,
           "mean_iters": [float(a.iter_count.double().mean())
                          for a in w.answers],
           "failed": failed, "attempted": attempted,
           "numbers": {k: (v if math.isfinite(v) else str(v))
                       for k, v in worst.items()},
           "over": over[:SHOWN],
           "stationarity_gap": stationarity_gap(pers, w.answers)}
    if n_witness:
        out["witness"] = witness(c, w, over, n_witness, root)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--witness", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    registry.set_cache_env()
    device = torch.device(args.device)
    harness.build_kernels(device)
    # one untimed solve first, so no seed's walls carry the first calls
    c = harness.prepare(args.workload, 0, device)
    harness.warm_up(c, device)
    del c
    for side, seeds in (("program", args.seeds),
                        ("control", args.control_seeds)):
        for s in (int(v) for v in seeds.split(",") if v):
            out = readings(args.workload, s, device,
                           "float32" if side == "control" else None,
                           n_witness=args.witness if side == "program"
                           else 0)
            print(json.dumps(out), flush=True)
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
