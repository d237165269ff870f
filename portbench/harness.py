"""One run of one cell: draw the pool, build the problem, warm up, run the
closed-loop window, judge every answer with the plain reference, read the
metrics.

The program under test is ``pyipm_tpu_torch``; from it the harness takes
``Problem``, ``IPMConfig``, the entry the mix names (``solve_batch`` or
``solve``), its counters and, in a traced run, its annotation ranges and
kernel names.  ``run_cell`` takes the device it runs on, so the CPU tests
drive every step but the look for a card (``run.py`` makes that).
"""

from __future__ import annotations

import importlib
import math
import time
from dataclasses import dataclass, field
from types import SimpleNamespace

import torch

from portbench import registry, tracing
from portbench.traffic import generator

PROGRAM = "pyipm_tpu_torch"
# the program's scope function: its ``ipm-*`` spans, timed on the device
# in a traced run
SCOPES = "pyipm_tpu_torch.utils.profiling:annotate"
# counters of the program, read before and after the window
COUNTERS = {
    "sync": ("pyipm_tpu_torch._sync", "COUNTS"),
}


@dataclass
class Answer:
    """What one call of the entry returned, as the reference reads it."""
    call: int                      # index into the pool
    x: torch.Tensor
    s: torch.Tensor
    lda: torch.Tensor
    fval: torch.Tensor
    signal: torch.Tensor
    iter_count: torch.Tensor
    kkt: torch.Tensor              # the solver's own KKT norms, (..., 4)


@dataclass
class Window:
    seconds: float = 0.0           # the window's wall, host clock
    walls: list = field(default_factory=list)
    answers: list = field(default_factory=list)
    peak_bytes: int = 0
    counters: dict = field(default_factory=dict)
    calls: list = field(default_factory=list)
    spans: list = field(default_factory=list)
    aligned: int = 0               # spans placed on the trace's timeline
    trace: object = None


def _snapshot():
    out = {}
    for key, (mod, name) in COUNTERS.items():
        out[key] = dict(getattr(importlib.import_module(mod), name))
    return out


def _delta(before, after):
    return {k: {n: after[k].get(n, 0) - before[k].get(n, 0)
                for n in after[k]} for k in after}


def sync_device(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build_kernels(device):
    """Import the program and, on a card, build (a checkout's first run)
    or load its kernel library."""
    build = importlib.import_module(PROGRAM + ".ops._build")
    if torch.device(device).type == "cuda":
        build.load()


def prepare(name: str, seed: int, device, root=registry.ROOT,
            float_dtype=None):
    """Everything set-up makes for cell ``name``: (cell, config, mix,
    problem, ipm config, entry, pool).  ``float_dtype`` replaces the
    configuration's (the control runs the program's float32 path on the
    same draw, cast)."""
    prog = importlib.import_module(PROGRAM)
    spec = registry.cell(name, root)
    cfg = registry.config(spec["config"], root)
    mix = registry.traffic(spec["traffic"], root)
    dtype = getattr(torch, cfg["float_dtype"])
    calls = generator.pool(cfg, mix, seed, device, dtype, root)
    ipm = prog.IPMConfig(float_dtype=float_dtype or cfg["float_dtype"],
                         **{**cfg["solver"], **mix.get("solver", {})})
    if float_dtype:
        low = getattr(torch, float_dtype)
        calls = [generator.Call(c.x0.to(low),
                                type(c.params)(*(t.to(low)
                                                 for t in c.params)))
                 for c in calls]
    fam = registry.family_math(cfg["family"], root)
    problem = prog.Problem(**fam.callables(generator.sizes_of(cfg, mix)))
    entry = getattr(prog, mix["entry"])
    return SimpleNamespace(spec=spec, config=cfg, mix=mix, problem=problem,
                           ipm=ipm, entry=entry, pool=calls)


def solve_once(c, call, index: int) -> Answer:
    res = c.entry(c.problem, call.x0, c.ipm, params=call.params)
    return Answer(index, res.x, res.s, res.lda, res.fval, res.signal,
                  res.iter_count, res.kkt)


def warm_up(c, device):
    """One whole solve of the pool's first call: every shape the window
    uses, every library handle, every kernel loaded."""
    solve_once(c, c.pool[0], 0)
    sync_device(device)


def window(c, seconds: float, device, trace: bool = False,
           call_specs: dict = None) -> Window:
    """The closed loop: calls of the pool in turn, the next once the last
    has returned and the device has finished, until ``seconds`` have
    passed; whole solves only."""
    w = Window()
    cuda = torch.device(device).type == "cuda"
    sync_device(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    before = _snapshot()
    prof, anchor = {}, []

    def loop():
        if trace and cuda:
            tracing.mark(anchor)
        t0 = time.perf_counter()
        i = 0
        while True:
            t = time.perf_counter()
            k = i % len(c.pool)
            w.answers.append(solve_once(c, c.pool[k], k))
            sync_device(device)
            now = time.perf_counter()
            w.walls.append(now - t)
            i += 1
            if now - t0 >= seconds:
                break
        w.seconds = time.perf_counter() - t0
        prof["window_s"] = w.seconds

    if trace:
        with tracing.record_calls(call_specs or {}, w.calls, PROGRAM), \
                tracing.record_spans(SCOPES, w.spans, PROGRAM):
            if cuda:
                with tracing.device_profile(prof):
                    loop()
                w.trace = prof["trace"]
                w.aligned = tracing.align_spans(w.trace, anchor, w.spans)
            else:
                loop()
        w.spans = []
    else:
        loop()
    w.counters = _delta(before, _snapshot())
    if cuda:
        w.peak_bytes = int(torch.cuda.max_memory_allocated(device))
    return w


def judge(c, w: Window, root=registry.ROOT):
    """The plain reference over every answer of the window, one call at a
    time: (numbers {name: largest value}, failed answers, attempted)."""
    ref = registry.reference(c.config["family"], root)
    worst, failed, attempted = {}, 0, 0
    limits = c.spec["limits"]
    for a in w.answers:
        per = ref.judge(c.pool[a.call].params, a)
        bad = None
        for k, v in per.items():
            v = v.reshape(-1)
            # NaN reads as a failure, never as a pass
            v = torch.where(torch.isnan(v), torch.full_like(v, math.inf), v)
            worst[k] = max(worst.get(k, 0.0), float(v.max()))
            if k not in limits:
                continue           # reported by the readings, not compared
            over = v > limits[k]
            bad = over if bad is None else (bad | over)
        failed += int(bad.sum())
        attempted += int(bad.numel())
    return worst, failed, attempted


def check_lines(worst: dict, limits: dict) -> list:
    return [f"check {k} {worst[k]!r} limit {limits[k]!r} "
            f"{'ok' if worst[k] <= limits[k] else 'FAILED'}"
            for k in limits]


def read_metrics(names, ctx, root=registry.ROOT) -> dict:
    out = {}
    for n in names:
        mod = registry.metric(n, root)
        v = mod.read(ctx)
        if v is not None:
            out[n] = {"value": v, "unit": mod.UNIT}
    return out


def call_specs(names, root=registry.ROOT) -> dict:
    specs = {}
    for n in names:
        specs.update(getattr(registry.metric(n, root), "CALLS", {}))
    return specs


def kkt_size(problem, ipm) -> int:
    """Rows of the linear system a direction factors: the condensed
    system eliminates the slacks and their multipliers."""
    D, M, N = problem.nvar, problem.neq, problem.nineq
    return D + M if ipm.linear_solver == "condensed" else D + M + 2 * N


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, root=registry.ROOT, device_info=None):
    """One run of cell ``name`` on ``device``; ``t_start`` is the
    process's start on ``time.perf_counter``.  Returns (the result line's
    object, the lines for standard error: set-up by part, the window's
    walls, then each compared number beside its limit)."""
    marks = [("start", t_start), ("imports", time.perf_counter())]
    build_kernels(device)
    marks.append(("build", time.perf_counter()))
    c = prepare(name, seed, device, root)
    marks.append(("draw", time.perf_counter()))
    warm_up(c, device)
    marks.append(("warm-up", time.perf_counter()))
    names = registry.cell_metrics(name, trace, root)
    specs = call_specs(names, root) if trace else {}
    setup_s = time.perf_counter() - t_start
    w = window(c, seconds, device, trace, specs)
    worst, failed, attempted = judge(c, w, root)
    limits = c.spec["limits"]
    correct = attempted > 0 and all(worst[k] <= lim
                                    for k, lim in limits.items())
    ctx = SimpleNamespace(cell=name, spec=c.spec, config=c.config,
                          mix=c.mix, problem=c.problem, ipm=c.ipm,
                          window=w, setup_s=setup_s,
                          kkt_size=kkt_size(c.problem, c.ipm))
    dev = dict(device_info or {})
    dev["memory_peak_bytes"] = w.peak_bytes
    if w.trace is not None:
        dev["busy_s"] = w.trace.busy_s
        dev["window_s"] = w.trace.window_s
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": read_metrics(names, ctx, root), "device": dev}
    if w.trace is not None:
        line["breakdown"] = {"device_ops": w.trace.top_ops(10),
                             "idle_gaps": w.trace.idle_gaps(10)}
    line["check"] = {k: {"value": worst[k], "limit": lim}
                     for k, lim in limits.items()}
    setup = "setup " + " ".join(f"{n}={b - a:.3f}" for (_, a), (n, b)
                                in zip(marks, marks[1:]))
    walls = "walls " + " ".join(f"{t:.4f}" for t in w.walls)
    return line, [setup, walls] + check_lines(worst, limits)
