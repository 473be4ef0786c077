"""The benchmark's run of one cell: find its configuration, family, traffic
mix, driver, metric readers and limits by name, run the driver, read the
metrics, decide ``correct``, and build the result line.

Everything that belongs to one configuration, one family, one mix or one
metric is a file of its own: ``configs/<config>.json`` (whose ``family``
names ``families/<family>.py``), ``traffic/<mix>.json`` (whose
``driver`` names ``drivers/<driver>.py``), ``metrics/<metric>.py`` (a
``read(record)`` that returns a number or None; a metric split by the
end-to-end metric it moves, ``<metric>.<part>``, falls back to
``metrics/<metric>.py``) and ``limits/<cell>.json``
(the limit of each number the cell's driver compares).  ``BENCHMARK.json`` says
which metrics a cell reports.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional, Tuple

from . import families

__all__ = ["HERE", "ROOT", "FORBIDDEN", "Context", "load_benchmark", "cell_of",
           "metrics_of", "reader_path", "reader", "run_cell", "limits_of", "read_limits",
           "forbidden_modules", "result_line"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def cell_of(bench: Dict, name: str) -> Dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The cell's end-to-end metrics (``trace`` false) or per-layer ones."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def reader_path(name: str) -> Path:
    """``metrics/<name>.py``, or for ``<base>.<part>`` without a file of its
    own, ``metrics/<base>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file() and "." in name:
        path = HERE / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    return path


def reader(name: str) -> Callable[[Dict], Optional[float]]:
    """The ``read`` of the metric's file (``reader_path``)."""
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Context:
    """What a driver is given for one run."""
    config_name: str
    cfg: Dict
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float
    control: bool = False
    fault: Optional[str] = None
    family: ModuleType = field(init=False)
    spec: object = field(init=False)
    marks: Dict[str, float] = field(default_factory=dict)

    def __post_init__(self):
        self.family = families.of(self.cfg)
        self.spec = self.family.spec_of(self.cfg)

    def mark(self, name: str) -> None:
        """Note the seconds since the run's start at a step of set-up or check."""
        self.marks[name] = time.perf_counter() - self.t0

    @property
    def cuda(self) -> bool:
        return getattr(self.device, "type", str(self.device)) == "cuda"

    def sync(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.synchronize()

    def memory_peak(self) -> int:
        if not self.cuda:
            return 0
        import torch
        torch.cuda.synchronize()
        return int(torch.cuda.max_memory_allocated())

    def free(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.empty_cache()


def run_cell(cell: Dict, seed: int, seconds: float, trace: bool, device, t0: float, *,
             control: bool = False, fault: Optional[str] = None,
             cfg: Optional[Dict] = None, traffic: Optional[Dict] = None) -> Dict:
    """Run the cell's driver and return its record (``cfg`` and ``traffic``
    replace the files' for tests at a small size)."""
    cfg = cfg or load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = traffic or load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    ctx = Context(cell["config"], cfg, traffic, int(seed), float(seconds), bool(trace), device,
                  t0, control=control, fault=fault)
    record = driver.run(ctx)
    record["setup_s"] = record["window"]["open"] - t0
    record["marks"] = ctx.marks
    return record


def limits_of(cell: Dict) -> Dict[str, float]:
    """``limits/<cell>.json``, as ``read_limits`` reads it (none where the
    file is missing)."""
    path = HERE / "limits" / f"{cell['name']}.json"
    return read_limits(path) if path.exists() else {}


def read_limits(path: Path) -> Dict[str, float]:
    """A limits file: the limit of each reading, and None for a reading the
    file names as not compared."""
    data = load_json(path)
    return {**data["limits"], **{n: None for n in data.get("not_compared", [])}}


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """Each reading beside its limit; correct when every reading that has a
    limit lies at or under it and every other is named as not compared."""
    checks = {n: {"value": v, "limit": limits.get(n)} for n, v in readings.items()}
    ok = all(n in limits and (c["limit"] is None or c["value"] <= c["limit"])
             for n, c in checks.items())
    return ok, checks


def result_line(bench: Dict, cell: Dict, record: Dict, trace: bool, device_info: Dict,
                limits: Dict[str, float]) -> Tuple[Dict, List[str]]:
    """The result object and the lines printed to standard error before it
    (each ratio's base, then each compared number beside its limit)."""
    notes: List[str] = []
    metrics = {}
    for m in metrics_of(bench, cell["name"], trace):
        value = reader(m["name"])(record)
        if value is None:
            notes.append(f"{m['name']}: nothing to read in this run; left out")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    notes += record.get("bases", [])
    notes.append("set-up and check, s from the start: " + ", ".join(
        f"{k} {v:.3f}" for k, v in record.get("marks", {}).items()))
    correct, checks = judge(record["readings"], limits)
    correct = correct and record["failed"] == 0
    device = dict(device_info, memory_peak_bytes=record["memory_peak_bytes"])
    out = {"correct": correct, "attempted": record["attempted"], "failed": record["failed"],
           "metrics": metrics, "device": device}
    if trace and "trace" in record:
        t, ops = record["trace"], record["trace_ops"]
        notes.append(f"trace of the device: {t['kernels']} kernels, busy {t['busy_s']!r} s "
                     f"of {t['window_s']!r} s")
        notes.append(f"trace with host ops: {ops['kernels']} kernels, {ops['attributed']} "
                     f"attributed to a host op; device s by op {ops['by_op']}")
        device.update(busy_s=t["busy_s"], window_s=t["window_s"])
        out["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": ops["idle_gaps"]}
    out["checks"] = checks
    for n, c in checks.items():
        notes.append(f"check {n} = {c['value']!r} limit {c['limit']!r}")
    return out, notes
