"""Roofline report from the dry run's per-rank counts, ported from
``repro/roofline/analysis.py``.

Three terms per (arch x shape x mesh), on the H100's data-sheet rates
(``HW``):

  compute    = device_flops / peak_flops
  memory     = device_bytes / hbm_bw
  collective = device_collective_bytes / link_bw

The counts are one rank's (``launch/dryrun.py``'s counter sees the local
ops of the SPMD program), so ``hlo_total_flops = device_flops x chips`` and
``useful_ratio = model_flops / hlo_total_flops``, as in the reference.  The
reference parses XLA's HLO text (``hloparse.py``); the port's counts come
from the dry run's dispatch mode instead, so ``analyze_counts`` takes the
counts themselves.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Any, Dict

__all__ = ["HW", "RooflineReport", "analyze_counts"]

# H100 SXM, from NVIDIA's data sheet, as ``runtime/executors.py`` assumes
# them: dense bf16 tensor-core FLOP/s, HBM3 bytes/s, and NVLink's 900 GB/s
# all to all as 450 GB/s each way.  Assumptions, not measurements.
HW = {
    "peak_flops": 989e12,
    "hbm_bw": 3.35e12,
    "ici_bw": 450e9,
}


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-device quantities
    device_flops: float
    device_bytes: float
    device_collective_bytes: float
    collectives_by_kind: Dict[str, int]
    # terms in seconds
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    # utilization
    model_flops: float
    hlo_total_flops: float
    useful_ratio: float
    # memory footprint
    argument_bytes: int = 0
    temp_bytes: int = 0
    output_bytes: int = 0
    notes: str = ""

    def to_json(self) -> Dict[str, Any]:
        return asdict(self)


def analyze_counts(counts, *, arch: str, shape: str, mesh_name: str, chips: int,
                   model_flops: float, notes: str = "", hw: Dict[str, float] = HW
                   ) -> RooflineReport:
    """The report of one rank's ``counts``: ``flops``, ``hbm_bytes``,
    ``collectives`` ({kind: bytes}), ``argument_bytes``, ``output_bytes``
    and ``peak`` (the live intermediate storage's peak, the temp bytes)."""
    dev_flops = float(counts.flops)
    dev_bytes = float(counts.hbm_bytes)
    by_kind = {k: int(v) for k, v in counts.collectives.items()}
    coll = sum(by_kind.values())
    compute_s = dev_flops / hw["peak_flops"]
    memory_s = dev_bytes / hw["hbm_bw"]
    collective_s = coll / hw["ici_bw"]
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    total_flops = dev_flops * chips
    ratio = model_flops / total_flops if total_flops else 0.0
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        device_flops=dev_flops, device_bytes=dev_bytes,
        device_collective_bytes=float(coll), collectives_by_kind=by_kind,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=model_flops,
        hlo_total_flops=total_flops, useful_ratio=ratio,
        argument_bytes=int(counts.argument_bytes), temp_bytes=int(counts.peak),
        output_bytes=int(counts.output_bytes), notes=notes)
