"""``BENCHMARK.json`` against the shape it must have: keys, names, units,
lengths, bounds and the files it names."""

import json
import re
from pathlib import Path

from portbench import registry

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "-m", "portbench.run"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert (REPO / c["file"]).is_file()
        assert c["reduced"] == []
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == names


def test_workloads():
    seen, pairs = set(), set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["name"] not in seen and _line(w["why"])
        seen.add(w["name"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert w["chips"] == 1
        assert (registry.ROOT / "traffic" / f"{w['traffic']}.json").is_file()
    assert 1 <= len(seen) <= 24


def test_metrics():
    names = set()
    e2e = BENCH["end_to_end"]
    assert {m["name"] for m in e2e} == {"solve_s", "peak_gib", "setup_s"}
    for m in e2e:
        assert set(m) == {"name", "unit", "better", "bound", "source"}
        assert m["source"] == "host_clock" and m["better"] == "lower"
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in e2e + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert registry.metric(m["name"]).UNIT == m["unit"]
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] == "solve_s" and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter")
        assert m["workloads"] and set(m["workloads"]) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%" and m["better"] == "higher"
    # every cell reports setup_s, another end-to-end metric, a per-layer one
    for c in cells:
        assert any(c in m["workloads"] for m in BENCH["per_layer"])
