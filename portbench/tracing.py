"""What a ``--trace 1`` run reads: the device's activity from
``torch.profiler``, the program's scopes, and the shapes of the calls into
named functions of the program.

The profiler records CUDA activity only: recording the host's events too
costs many times the window to process, and without them the profiler
shows no annotation ranges.  So each of the program's scopes (``ipm-*``)
is timed by a pair of CUDA events and placed on the trace's timeline at a
marker kernel launched right after an anchor event (:func:`align_spans`).
The trace is exported as a Chrome trace into a temporary directory and
reduced to intervals: kernels, copies and sets (the device's work) and
the scopes.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
import json
import os
import sys
import tempfile
from dataclasses import dataclass, field

WORK_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _merge(intervals):
    """Union of (start, end) intervals, sorted and disjoint."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


@dataclass
class DeviceTrace:
    """The device timeline of one traced window, in seconds.

    ``work``: (name, start, end) of every kernel, copy and set;
    ``annotations``: (name, start, end) of every scope of the program;
    ``window_s``: the traced window's wall (host clock)."""
    work: list
    annotations: list
    window_s: float
    _busy: list = field(default=None, repr=False)
    _starts: list = field(default=None, repr=False)

    def _index(self):
        if self._busy is None:
            self._busy = _merge((a, b) for _, a, b in self.work)
            self._starts = [a for a, _ in self._busy]
        return self._busy

    @property
    def busy_s(self) -> float:
        """Seconds in which some work ran on the device."""
        return sum(b - a for a, b in self._index())

    def busy_between(self, a: float, b: float) -> float:
        """Busy seconds inside [a, b]."""
        busy = self._index()
        if b <= a or not busy:
            return 0.0
        i = bisect.bisect_right(self._starts, a) - 1
        j = bisect.bisect_left(self._starts, b)
        total = 0.0
        for k in range(max(i, 0), j):
            lo, hi = busy[k]
            total += max(0.0, min(hi, b) - max(lo, a))
        return total

    def busy_in(self, names) -> float:
        """Busy seconds inside the union of the annotation ranges named
        ``names``."""
        ranges = _merge((a, b) for n, a, b in self.annotations
                        if n in names)
        return sum(self.busy_between(a, b) for a, b in ranges)

    def kernel_s(self, substrings) -> tuple:
        """(seconds, launches) of the kernels whose name holds one of
        ``substrings``."""
        sel = [(a, b) for n, a, b in self.work
               if any(s in n for s in substrings)]
        return sum(b - a for a, b in sel), len(sel)

    def launches(self) -> int:
        return sum(1 for n, _, _ in self.work if not n.startswith("Mem"))

    def top_ops(self, k: int = 10) -> list:
        """The k device operations that took most time: [name, seconds]
        (a kernel's name without its parameter list)."""
        tot = {}
        for n, a, b in self.work:
            key = short_name(n)
            tot[key] = tot.get(key, 0.0) + (b - a)
        return [[n, s] for n, s in
                sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """Idle time between device work, summed by the innermost
        annotation range that covers each gap (what the host was doing),
        the k largest: [label, seconds]."""
        busy = self._index()
        # annotation ranges nest: a sweep keeps the open ones on a stack
        anns = sorted(((a, b, n) for n, a, b in self.annotations),
                      key=lambda t: (t[0], -t[1]))
        tot, stack, j = {}, [], 0
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            mid = 0.5 * (e0 + s1)
            while j < len(anns) and anns[j][0] <= mid:
                stack.append(anns[j])
                j += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            label = (f"host in {stack[-1][2]}" if stack
                     else "outside the solver's scopes")
            tot[label] = tot.get(label, 0.0) + (s1 - e0)
        return [[n, s] for n, s in
                sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


def short_name(name: str, width: int = 160) -> str:
    """A kernel's demangled name without its trailing parameter list."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.strip()[:width]


def read_chrome_trace(path: str, window_s: float) -> DeviceTrace:
    with open(path) as fh:
        events = json.load(fh)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    work = [(e.get("name", ""), float(e["ts"]) * 1e-6,
             (float(e["ts"]) + float(e["dur"])) * 1e-6)
            for e in events
            if e.get("ph") == "X" and "dur" in e
            and e.get("cat", "") in WORK_CATS]
    return DeviceTrace(work, [], window_s)


@contextlib.contextmanager
def device_profile(out: dict):
    """Profile the block's CUDA activity; on exit ``out["trace"]`` is its
    :class:`DeviceTrace` (the caller sets ``out["window_s"]`` inside)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        out["trace"] = read_chrome_trace(path, out["window_s"])


def _replace_everywhere(fn, new, package: str, patched: list):
    """Bind ``new`` wherever a module of ``package`` holds ``fn``."""
    for name, mod in list(sys.modules.items()):
        if mod is None or not (name == package
                               or name.startswith(package + ".")):
            continue
        for attr, val in list(vars(mod).items()):
            if val is fn:
                setattr(mod, attr, new)
                patched.append((mod, attr, fn))


def _resolve(spec: str):
    mod, _, name = spec.partition(":")
    return getattr(importlib.import_module(mod), name)


@contextlib.contextmanager
def record_calls(specs: dict, log: list, package: str):
    """While the block runs, every module of ``package`` that holds one of
    the functions ``specs`` ({label: "module:function"}) calls a wrapper
    that appends (label, shapes of its tensor arguments, dtype) to
    ``log``.  Restores every name on exit."""
    import torch

    def wrap(label, fn):
        @functools.wraps(fn)
        def recorded(*args, **kw):
            ts = [a for a in args if isinstance(a, torch.Tensor)]
            log.append((label, tuple(tuple(t.shape) for t in ts),
                        str(ts[0].dtype).replace("torch.", "") if ts
                        else None))
            return fn(*args, **kw)
        return recorded

    patched = []
    try:
        for label, spec in specs.items():
            fn = _resolve(spec)
            _replace_everywhere(fn, wrap(label, fn), package, patched)
        yield
    finally:
        for mod, attr, fn in patched:
            setattr(mod, attr, fn)


@contextlib.contextmanager
def record_spans(spec: str, spans: list, package: str):
    """While the block runs, the program's scope function ``spec``
    ("module:function", a context manager ``(name, device=None)``) also
    records a pair of CUDA events around each scope on a card, appending
    (name, start event, end event) to ``spans``: the scope's time on the
    device's stream, from the work before it to the work inside it done
    (:func:`span_seconds`).  Restores every name on exit."""
    import torch

    fn = _resolve(spec)

    @contextlib.contextmanager
    def timed(name, device=None):
        with fn(name, device):
            cuda = device is not None and torch.device(device).type == "cuda"
            if not cuda:
                yield
                return
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
            try:
                yield
            finally:
                e1 = torch.cuda.Event(enable_timing=True)
                e1.record()
                spans.append((name, e0, e1))

    patched = []
    try:
        _replace_everywhere(fn, timed, package, patched)
        yield
    finally:
        for mod, attr, f in patched:
            setattr(mod, attr, f)


MARKER = "spin_kernel"      # torch.cuda._sleep's kernel: the clocks' anchor


def mark(anchor: list):
    """Record a CUDA event and launch the marker kernel right after it:
    the kernel's start in the trace and the event are one instant on the
    two clocks (appends the event to ``anchor``)."""
    import torch
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    torch.cuda._sleep(1)
    anchor.append(e)


def align_spans(trace: DeviceTrace, anchor, spans: list) -> int:
    """Place the CUDA-event spans on the trace's timeline as annotation
    ranges (name, start, end), anchored at the marker kernel; returns how
    many were placed (0 where the trace shows no marker)."""
    starts = [a for n, a, _ in trace.work if MARKER in n]
    if not starts or not anchor:
        return 0
    t0, ref = min(starts), anchor[0]
    for name, e0, e1 in spans:
        e1.synchronize()
        trace.annotations.append((name, t0 + ref.elapsed_time(e0) / 1e3,
                                  t0 + ref.elapsed_time(e1) / 1e3))
    return len(spans)
