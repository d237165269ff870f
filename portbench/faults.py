"""Faults planted in the timed path, each of which the check has to
catch: the program's answers come out wrong underneath an otherwise
whole run.

    python3 -m portbench.faults --workload <cell> --seeds 1,2,3
        [--seconds 2] [--device cuda]

runs the cell (set-up, window, check) once a seed with each fault that
applies to its entry planted, and prints one JSON line a fault and seed:
``correct``, ``failed``, ``attempted`` and the compared numbers.  The
benchmark's own runs never plant one.

  - ``unchanged_state``: an iteration returns its state as it came, its
    count bumped;
  - ``half_batch``: a ``solve_batch`` call solves the first half of its
    batch and repeats those answers for the rest;
  - ``altered_answer``: x[:, 0] moved by 1e-7 where the answer is made;
  - ``initial_barrier``: every iteration steps toward the initial
    barrier's central point, whatever the barrier's schedule says, so an
    instance stops there with its KKT norms at that barrier under Ktol.
"""

import argparse
import contextlib
import json
import sys
import time
from unittest import mock

import torch

from portbench import harness, registry


@contextlib.contextmanager
def unchanged_state():
    from pyipm_tpu_torch.core.solver import BatchSolver
    with mock.patch.object(
            BatchSolver, "inner_iter",
            lambda self, st, p: st._replace(iter_count=st.iter_count + 1)):
        yield


@contextlib.contextmanager
def half_batch():
    import pyipm_tpu_torch
    solve_batch = pyipm_tpu_torch.solve_batch

    def half(problem, x0, config=None, s0=None, lda0=None, params=()):
        h = x0.shape[0] // 2
        res = solve_batch(problem, x0[:h], config,
                          params=type(params)(*(t[:h] for t in params)))
        n = x0.shape[0] - h
        return res._replace(**{k: torch.cat([getattr(res, k),
                                             getattr(res, k)[:n]])
                               for k in ("x", "s", "lda", "fval", "signal",
                                         "iter_count")})

    with mock.patch.object(pyipm_tpu_torch, "solve_batch", half):
        yield


@contextlib.contextmanager
def altered_answer():
    from pyipm_tpu_torch.core.solver import BatchSolver
    finalize = BatchSolver.finalize

    def altered(self, st, p=()):
        res = finalize(self, st, p)
        x = res.x.clone()
        x[:, 0] += 1e-7
        return res._replace(x=x)

    with mock.patch.object(BatchSolver, "finalize", altered):
        yield


@contextlib.contextmanager
def initial_barrier():
    from pyipm_tpu_torch.core.solver import BatchSolver
    inner_iter = BatchSolver.inner_iter

    def fixed(self, st, p):
        mu0 = torch.full_like(st.mu, self.config.mu)
        return inner_iter(self, st._replace(mu=mu0), p)._replace(mu=st.mu)

    with mock.patch.object(BatchSolver, "inner_iter", fixed):
        yield


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_answer": altered_answer,
          "initial_barrier": initial_barrier}


def applies(fault: str, spec: dict, root=registry.ROOT) -> bool:
    """Whether ``fault`` can occur in cell ``spec``: half of a batch only
    where a call solves a batch, a barrier only where there are
    inequalities."""
    mix = registry.traffic(spec["traffic"], root)
    if fault == "half_batch":
        return mix["entry"] == "solve_batch"
    if fault == "initial_barrier":
        cfg = registry.config(spec["config"], root)
        fam = registry.family_math(cfg["family"], root)
        return fam.callables(
            {**cfg.get("sizes", {}), **mix.get("sizes", {})})["nineq"] > 0
    return True


def run_with(fault: str, name: str, seed: int, seconds: float, device,
             root=registry.ROOT) -> dict:
    with FAULTS[fault]():
        line, _ = harness.run_cell(name, seed, seconds, False, device,
                                   time.perf_counter(), root=root)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.faults")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    registry.set_cache_env()
    device = torch.device(args.device)
    harness.build_kernels(device)
    spec = registry.cell(args.workload)
    for fault in FAULTS:
        if not applies(fault, spec):
            continue
        for seed in (int(v) for v in args.seeds.split(",") if v):
            t = time.perf_counter()
            line = run_with(fault, args.workload, seed, args.seconds,
                            device)
            print(json.dumps({"fault": fault, "seed": seed,
                              "correct": line["correct"],
                              "failed": line["failed"],
                              "attempted": line["attempted"],
                              "check": line["check"],
                              "took_s": time.perf_counter() - t}),
                  flush=True)
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
