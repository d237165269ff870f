"""What a run may load, and what its last line carries."""

import ast
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench import harness, run

PKG = Path(__file__).resolve().parents[1]
REPO = PKG.parent
BANNED = {"jax", "jaxlib", "flax", "pyipm_tpu"}


def _top_imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_a_run_loads_no_jax_and_no_jax_package(tiny_root):
    """Every module a run imports, the program's own included, by
    top-level name compared whole (``pyipm_tpu_torch`` is not
    ``pyipm_tpu``)."""
    code = (
        "import sys, time, json\n"
        "from portbench import run, harness\n"
        f"line, _ = harness.run_cell('markowitz.book1024x500', 3, 0.01,"
        f" True, 'cpu', time.perf_counter(), root=__import__('pathlib')"
        f".Path({str(tiny_root)!r}))\n"
        "line, _ = harness.run_cell('dense4352.ldlt', 3, 0.01, False,"
        f" 'cpu', time.perf_counter(), root=__import__('pathlib')"
        f".Path({str(tiny_root)!r}))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600,
                         check=True).stdout
    tops = set(json.loads(out.splitlines()[-1]))
    assert "pyipm_tpu_torch" in tops
    assert not tops & BANNED


def test_no_file_of_the_benchmark_imports_jax():
    for path in PKG.rglob("*.py"):
        assert not _top_imports(path) & BANNED, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (PKG / "reference").glob("*.py"):
        tops = _top_imports(path)
        assert tops <= {"math", "torch"}, (path, tops)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pyipm_tpu_torch_fake", object())
    assert "pyipm_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pyipm_tpu", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert {"pyipm_tpu", "jax"} <= set(run.forbidden_modules())


@pytest.mark.parametrize("trace", [False, True])
def test_the_line_carries_the_result_keys(tiny_root, trace):
    line, checks = harness.run_cell("dense4352.condensed", 9, 0.01, trace,
                                    "cpu", time.perf_counter(),
                                    root=tiny_root,
                                    device_info={"platform": "cpu"})
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "check" and set(keys) <= {
        "correct", "attempted", "failed", "metrics", "device",
        "breakdown", "check"}
    assert line["correct"] is True and line["failed"] == 0
    assert checks[0].startswith("setup ") and checks[1].startswith("walls ")
    assert len(checks[2:]) == len(line["check"])
    assert all(c.startswith("check ") for c in checks[2:])
    for k, v in line["check"].items():
        assert set(v) == {"value", "limit"}
    want = {"solve_s", "setup_s"} if not trace else {"iters", "host_syncs"}
    assert want <= set(line["metrics"])
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    json.dumps(line)


def test_no_card_no_result():
    """Without a card the run exits non-zero and prints nothing on
    standard output."""
    p = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "markowitz.book1024x500", "--seed", "2147483700", "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin",
                          "HOME": str(REPO)})
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_no_program_no_result(tmp_path):
    """A directory that holds only ``BENCHMARK.json`` and the benchmark's
    files gives no result."""
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "dense4352.condensed", "--seed", "5", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
