"""The check that decides ``correct``: the control (the program's own
float32 path on the same draw) and planted faults of the timed path come
out not correct; sound float64 runs come out correct."""

import time

import pytest
import torch

from portbench import faults, harness, readings, registry

CELLS = ["markowitz.book1024x500", "dense4352.condensed", "dense4352.ldlt"]
SEEDS = [2 ** 31 + 11, 7, 123456789]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(tiny_root, cell):
    for seed in SEEDS:
        prog = readings.readings(cell, seed, torch.device("cpu"), None,
                                 tiny_root)
        ctrl = readings.readings(cell, seed, torch.device("cpu"), "float32",
                                 tiny_root)
        assert prog["failed"] == 0 and prog["over"] == [], prog
        assert ctrl["failed"] > 0 and ctrl["over"], ctrl


@pytest.mark.parametrize("fault, cell", [
    (f, c) for f in faults.FAULTS for c in CELLS
    if f not in ("half_batch", "initial_barrier") or c.startswith("mark")])
def test_planted_fault_is_not_correct(tiny_root, fault, cell):
    spec = registry.cell(cell, tiny_root)
    assert faults.applies(fault, spec, tiny_root)
    line = faults.run_with(fault, cell, SEEDS[0], 0.01, "cpu", tiny_root)
    assert line["correct"] is False and line["failed"] > 0


def test_faults_that_cannot_occur_are_not_planted(tiny_root):
    spec = registry.cell("dense4352.ldlt", tiny_root)
    assert not faults.applies("half_batch", spec, tiny_root)
    assert not faults.applies("initial_barrier", spec, tiny_root)


def test_a_central_point_fails_complementarity(tiny_root):
    """An instance stopped at the initial barrier's central point passes
    stationarity, reads its barrier in every complementary pair, and lies
    above the witness's optimum."""
    with faults.initial_barrier():
        out = readings.readings("markowitz.book1024x500", SEEDS[1],
                                torch.device("cpu"), None, tiny_root,
                                n_witness=2)
    assert out["numbers"]["unconverged"] == 0.0
    assert out["numbers"]["stationarity"] < 1e-4
    assert out["numbers"]["complementarity"] > 1.0
    assert out["over"] and all(set(bad) == {"complementarity"}
                               for _, _, bad, _ in out["over"])
    assert all(w["past_a_limit"] and w["f_minus_witness"] > 1e-2
               for w in out["witness"])


def test_the_witness_agrees_with_a_sound_answer(tiny_root):
    """Within Ktol: a sound answer's objective lies above the optimum by
    at most its KKT residuals times the distance to it."""
    out = readings.readings("markowitz.book1024x500", SEEDS[2],
                            torch.device("cpu"), None, tiny_root,
                            n_witness=2)
    assert len(out["witness"]) == 2
    for w in out["witness"]:
        assert not w["past_a_limit"] and w["witness"]["feas"] < 1e-12
        assert -1e-10 < w["f_minus_witness"] < 1e-4


@pytest.mark.cuda
def test_first_cell_on_the_card(card):
    """On a card: a short run of the first cell at its real size comes
    out correct (the benchmark's own runs hold every cell)."""
    first = registry.benchmark()["workloads"][0]["name"]
    line, _ = harness.run_cell(first, 2 ** 31 + 99, 1.0, False, card,
                               time.perf_counter(),
                               device_info={"platform": "gpu"})
    assert line["correct"] is True
