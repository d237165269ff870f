"""How well a traced benchmark run places the program's scopes on the
device trace's timeline, on a card.

    python3 scripts/span_alignment_probe.py {cold,warm} [SECONDS]

Opens the ``ipm-k3-panel`` scope around one elementwise kernel, over and
over for SECONDS (default 25) with random host pauses of 0-2 ms and a
4096 x 4096 float64 product queued every 50 scopes, under the benchmark's
own ``portbench.tracing.record_spans`` and ``device_profile``; marks the
clocks' anchor with ``tracing.mark`` at the start, as the harness does,
and once more at the end.  ``cold`` leaves the marker kernel's first
launch to that first mark, as a benchmark run does; ``warm`` launches it
once before, and also times an empty scope: plain, under
``record_spans``, and with the profiler on too.

Prints one JSON line: the second marker's distance from where the first
marker and the events place it (``drift_us_at_end``), and, with each
scope paired to its kernel in order, the share of kernels wholly inside
their span and the kernel's start less the span's start (quartiles, and
the median in each tenth of the window), for the spans as
``tracing.align_spans`` places them (``single``) and re-placed linearly
between the two markers (``linear``).
"""

import json
import os
import random
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from portbench import harness, tracing  # noqa: E402
from pyipm_tpu_torch.utils import profiling  # noqa: E402

SCOPE = "ipm-k3-panel"


def scope_us(dev, n=3000):
    """Host microseconds of one empty scope."""
    t = time.perf_counter()
    for _ in range(n):
        with profiling.annotate(SCOPE, dev):
            pass
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e6


def placement(kern, ann, f, m0):
    """Inside share and leads of kernels ``kern`` paired in order with
    spans ``ann`` re-placed by ``f``."""
    lead = [a - f(sa) for (a, _), (sa, _) in zip(kern, ann)]
    trail = [f(sb) - b for (_, b), (_, sb) in zip(kern, ann)]
    inside = sum(1 for u, v in zip(lead, trail) if u >= 0 and v >= 0)
    span = kern[-1][0] - m0
    tenths = []
    for d in range(10):
        sel = [u for (a, _), u in zip(kern, lead)
               if d * span / 10 <= a - m0 < (d + 1) * span / 10]
        tenths.append(round(1e6 * statistics.median(sel), 2) if sel
                      else None)
    return {"inside": inside / len(kern),
            "lead_us_q": [round(1e6 * q, 2)
                          for q in statistics.quantiles(lead, n=4)],
            "lead_us_min": 1e6 * min(lead),
            "trail_us_min": 1e6 * min(trail),
            "lead_us_median_by_tenth": tenths}


def main(argv):
    warm = argv[0] == "warm"
    seconds = float(argv[1]) if len(argv) > 1 else 25.0
    dev = torch.device("cuda:0")
    x = torch.ones(1024, device=dev)
    big = torch.randn(4096, 4096, dtype=torch.float64, device=dev)
    x.mul_(1.0)
    big @ big
    torch.cuda.synchronize()
    out = {"warm": warm, "card": torch.cuda.get_device_name(dev)}
    if warm:
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        out["scope_us_plain"] = scope_us(dev)
        with tracing.record_spans(harness.SCOPES, [], harness.PROGRAM):
            out["scope_us_spans"] = scope_us(dev)
            with tracing.device_profile({"window_s": 1.0}):
                out["scope_us_spans_profiled"] = scope_us(dev)
    rng = random.Random(5)
    spans, anchor, prof = [], [], {}
    with tracing.record_spans(harness.SCOPES, spans, harness.PROGRAM):
        with tracing.device_profile(prof):
            tracing.mark(anchor)
            t0 = time.perf_counter()
            n = 0
            while time.perf_counter() - t0 < seconds:
                if n % 50 == 0:
                    big @ big
                with profiling.annotate(SCOPE, dev):
                    x.mul_(1.0000001)
                n += 1
                end = time.perf_counter() + rng.uniform(0, 0.002)
                while time.perf_counter() < end:
                    pass
            torch.cuda.synchronize()
            tracing.mark(anchor)
            torch.cuda.synchronize()
            prof["window_s"] = time.perf_counter() - t0
    tr = prof["trace"]
    marks = sorted(a for nm, a, _ in tr.work if tracing.MARKER in nm)
    tracing.align_spans(tr, anchor, spans)
    m0, m1 = marks[0], marks[-1]
    el1 = anchor[0].elapsed_time(anchor[1]) / 1e3
    out["drift_us_at_end"] = 1e6 * (m1 - (m0 + el1))
    kern = sorted((a, b) for nm, a, b in tr.work
                  if "elementwise" in nm.lower())
    ann = sorted((a, b) for nm, a, b in tr.annotations if nm == SCOPE)
    out["kernels"], out["spans"] = len(kern), len(ann)
    if kern and len(kern) == len(ann):
        scale = (m1 - m0) / el1
        out["single"] = placement(kern, ann, lambda t: t, m0)
        out["linear"] = placement(kern, ann,
                                  lambda t: m0 + (t - m0) * scale, m0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
