"""Finds each part of the benchmark by its name.

  - ``configs/<config>.json``: a configuration (the family, its sizes,
    its constants and the solver settings it is run at);
    ``configs/<family>.py``: the family's mathematics, f, ce and ci as a
    user writes them, and its start;
  - ``traffic/<mix>.json``: a traffic mix, read by ``traffic/generator.py``;
    ``traffic/<family>.py``: the family's sampler, on the device;
  - ``workloads/<cell>.json``: a cell (configuration, traffic, chips and
    the limits of its check);
  - ``metrics/<metric>.py``: a metric's reader, ``read(ctx)`` -> value or
    None, with ``UNIT`` and optionally ``CALLS`` (functions of the program
    whose call shapes a traced run records);
  - ``reference/<family>.py``: the plain reference that judges a family's
    answers;
  - ``witness/<family>.py``: a second witness of a family's optimum, which
    ``readings.py`` consults (never a run).

A later cell, mix, configuration or metric is a new file; nothing here
lists them.
"""

from __future__ import annotations

import importlib.util
import json
import os
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _json(kind: str, name: str, root: Path = ROOT) -> dict:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no {kind[:-1] if kind.endswith('s') else kind} "
                       f"named {name!r} ({path})")
    with open(path) as fh:
        return json.load(fh)


def _module(kind: str, name: str, root: Path = ROOT):
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} module named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _names(kind: str, suffix: str, root: Path = ROOT) -> list:
    d = root / kind
    return sorted(p.name[:-len(suffix)] for p in d.glob(f"*{suffix}")
                  if not p.name.startswith("_"))


def cell(name: str, root: Path = ROOT) -> dict:
    return _json("workloads", name, root)


def config(name: str, root: Path = ROOT) -> dict:
    return _json("configs", name, root)


def traffic(name: str, root: Path = ROOT) -> dict:
    return _json("traffic", name, root)


def family_math(family: str, root: Path = ROOT):
    return _module("configs", family, root)


def sampler(family: str, root: Path = ROOT):
    return _module("traffic", family, root)


def reference(family: str, root: Path = ROOT):
    return _module("reference", family, root)


def witness(family: str, root: Path = ROOT):
    return _module("witness", family, root)


def metric(name: str, root: Path = ROOT):
    return _module("metrics", name, root)


def cells(root: Path = ROOT) -> list:
    return _names("workloads", ".json", root)


def metrics(root: Path = ROOT) -> list:
    return _names("metrics", ".py", root)


def benchmark(root: Path = ROOT) -> dict:
    """``BENCHMARK.json`` beside the folder, or {} where there is none."""
    path = root.parent / "BENCHMARK.json"
    if not path.is_file():
        return {}
    with open(path) as fh:
        return json.load(fh)


def cell_metrics(name: str, trace: bool, root: Path = ROOT) -> list:
    """The metric names a run of cell ``name`` reports: its end-to-end
    metrics with ``trace`` 0, its per-layer ones with 1, as
    ``BENCHMARK.json`` lists them (a metric with ``workloads`` only in
    those cells).  Where ``BENCHMARK.json`` does not name the cell, every
    reader in ``metrics/`` of that kind (``KIND`` in the reader)."""
    bench = benchmark(root)
    if name in {w["name"] for w in bench.get("workloads", [])}:
        entries = bench["per_layer" if trace else "end_to_end"]
        return [m["name"] for m in entries
                if name in m.get("workloads", [name])]
    want = "per_layer" if trace else "end_to_end"
    return [m for m in metrics(root)
            if getattr(metric(m, root), "KIND", "per_layer") == want]


def cache_dirs(root: Path = ROOT) -> dict:
    """Fixed build and kernel-cache directories inside the checkout."""
    base = root / ".cache"
    return {"TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "TRITON_CACHE_DIR": str(base / "triton")}


def set_cache_env(root: Path = ROOT):
    for k, v in cache_dirs(root).items():
        os.environ[k] = v
