"""Small configurations, mixes and limits, for driving whole runs of the
benchmark on the CPU (the port's plain PyTorch path).

A configuration's small size is its family's (``small``); a cell's limits
at that size are ``tests/limits/<cell>.json``, in the form of the cell's
own limits file, each saying what readings it was set from."""

from __future__ import annotations

import copy
from pathlib import Path

from portbench import families, harness

SEED = 3_000_000_019      # above 2**31: a seed may need more than 32 signed bits
LIMITS = Path(__file__).resolve().parent / "limits"


def small_config(name: str = "qwen3-1.7b") -> dict:
    cfg = harness.load_json(harness.HERE / "configs" / f"{name}.json")
    return families.of(cfg).small(cfg)


def small_limits(cell: str) -> dict:
    """The cell's limits at the small size; a missing file is named."""
    path = LIMITS / f"{cell}.json"
    if not path.is_file():
        raise FileNotFoundError(f"the cell {cell} has no limits at the CPU tests' size: "
                                f"{path} is missing")
    return harness.read_limits(path)


def small_traffic(mix: str) -> dict:
    t = copy.deepcopy(harness.load_json(harness.HERE / "traffic" / f"{mix}.json"))
    if t["driver"] == "serve":
        t.update(slots=4, max_seq=64, clients=4, pool=64, warm_step=8, warm_iterations=2,
                 check_requests=3,
                 prompt={"median": 16, "sigma": 0.5, "min": 8, "max": 40},
                 output={"median": 8, "sigma": 0.5, "min": 4, "max": 16})
    else:
        t.update(rows=2, seq=64, document={"median": 10, "sigma": 1.0, "min": 2, "max": 100})
    return t
