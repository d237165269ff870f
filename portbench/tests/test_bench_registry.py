"""The harness finds cells, mixes and metrics by their files alone."""

import json
import time

from portbench import harness, registry

DUMMY_METRIC = '''"""A metric added as a file alone."""

UNIT = "solves"


def read(ctx):
    return float(len(ctx.window.walls))
'''


def test_lists_the_committed_cells_and_metrics():
    """Every cell of ``BENCHMARK.json`` has its file; a cell file it does
    not name waits for a later PR (PERF.md, Open questions)."""
    bench = registry.benchmark()
    assert {w["name"] for w in bench["workloads"]} <= set(registry.cells())
    named = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    assert named == set(registry.metrics())
    for w in bench["workloads"]:
        spec = registry.cell(w["name"])
        assert (spec["config"], spec["traffic"], spec["chips"]) == (
            w["config"], w["traffic"], w["chips"])


def test_a_cell_and_a_metric_added_as_files_alone(tiny_root):
    (tiny_root / "traffic" / "tiny.json").write_text(json.dumps(
        {"entry": "solve_batch", "batch": 3, "sizes": {"nassets": 8},
         "pool": 1, "solver": {}}))
    (tiny_root / "workloads" / "markowitz.tiny.json").write_text(json.dumps(
        {"config": "markowitz", "traffic": "tiny", "chips": 1,
         "limits": registry.cell("markowitz.book1024x500")["limits"]}))
    (tiny_root / "metrics" / "dummy_solves.py").write_text(DUMMY_METRIC)
    assert "markowitz.tiny" in registry.cells(tiny_root)
    assert "dummy_solves" in registry.metrics(tiny_root)
    # BENCHMARK.json does not name the cell: every per-layer reader runs
    assert "dummy_solves" in registry.cell_metrics("markowitz.tiny", True,
                                                   tiny_root)
    line, _ = harness.run_cell("markowitz.tiny", 5, 0.01, True, "cpu",
                               time.perf_counter(), root=tiny_root)
    assert line["correct"] is True
    assert line["metrics"]["dummy_solves"]["value"] >= 1.0
    assert line["metrics"]["dummy_solves"]["unit"] == "solves"


def test_cell_metrics_follow_benchmark_json():
    bench = registry.benchmark()
    for w in bench["workloads"]:
        e2e = registry.cell_metrics(w["name"], False)
        assert set(e2e) == {"solve_s", "peak_gib", "setup_s"}
        per = registry.cell_metrics(w["name"], True)
        assert per and all(
            w["name"] in m["workloads"] for m in bench["per_layer"]
            if m["name"] in per)
