"""Whole runs on the CPU at a small size (each configuration's family's
``small``; limits of this size in ``tests/limits/<cell>.json``), with the
look for a card skipped:
a sound run is ``correct``; with the timed path broken underneath (a step
that leaves its state unchanged, half of the batch left out, a token or an
answer altered where it is produced) it is not; and the fp8 control's
readings fail a limit.  One chip, so no exchange between chips to leave
out."""

import time

import pytest
import torch

import small
from portbench import faults, harness

BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _run(cell_name, fault=None, control=False):
    cell = harness.cell_of(BENCH, cell_name)
    cfg = small.small_config(cell["config"])
    traffic = small.small_traffic(cell["traffic"])
    seconds = 1.0 if traffic["driver"] == "serve" else 0.3
    rec = harness.run_cell(cell, small.SEED, seconds, False, torch.device("cpu"),
                           time.perf_counter(), control=control, fault=fault, cfg=cfg,
                           traffic=traffic)
    info = {"platform": "cpu", "kind": "cpu", "count": 1}
    out, notes = harness.result_line(BENCH, cell, rec, False, info,
                                     small.small_limits(cell_name))
    return rec, out, notes


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_has_small_limits(cell):
    path = small.LIMITS / f"{cell}.json"
    assert path.is_file(), f"{path} is missing: the cell's limits at the CPU tests' size"
    assert small.small_limits(cell)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_control_fails(cell):
    rec, out, notes = _run(cell, control=True)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert notes[-len(out["checks"]):] == [
        f"check {n} = {c['value']!r} limit {c['limit']!r}" for n, c in out["checks"].items()]
    ok, _ = harness.judge(rec["control"], small.small_limits(cell))
    assert not ok, rec["control"]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(cell, fault):
    _, out, _ = _run(cell, fault=fault)
    assert not out["correct"], out["checks"]
