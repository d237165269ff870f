"""Fixtures of the benchmark's own tests: a copy of ``portbench/`` with
the traffic and the dense configuration cut to sizes a CPU test run holds
(every file else as committed)."""

import json
import shutil
from pathlib import Path

import pytest
import torch

SRC = Path(__file__).resolve().parents[1]

TINY_TRAFFIC = {
    "book1024x500": dict(batch=6, sizes={"nassets": 20}, pool=2),
    "single_condensed": dict(pool=2),
    "single_ldlt": dict(pool=2),
}
TINY_DENSE = {"nvar": 24, "neq": 4, "hidden": 6}


def _edit(path: Path, **changes):
    d = json.loads(path.read_text())
    d.update(changes)
    path.write_text(json.dumps(d))


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """A copy of the benchmark at tiny sizes; ``BENCHMARK.json`` beside
    it as committed."""
    root = tmp_path / "portbench"
    shutil.copytree(SRC, root, ignore=shutil.ignore_patterns(
        "__pycache__", ".cache", "tests"))
    bench = SRC.parent / "BENCHMARK.json"
    if bench.is_file():
        shutil.copy(bench, tmp_path / "BENCHMARK.json")
    for name, ch in TINY_TRAFFIC.items():
        _edit(root / "traffic" / f"{name}.json", **ch)
    _edit(root / "configs" / "dense4352.json", sizes=TINY_DENSE)
    return root


@pytest.fixture
def card():
    """The first CUDA device; skips where there is none (decided here,
    never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda:0")


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 4))
    yield
    torch.set_num_threads(prev)
