"""Workflow applications: shard / align / merge over the data lake.

The scatter–gather building blocks the scenario suite runs (a Magic-BLAST
shaped pipeline: split a read set into segments, align each segment
wherever the network placed it, merge the per-segment results):

* ``wf-shard`` — read a named dataset from the lake, split it into
  ``parts`` contiguous segments, publish each under the stage's result
  name (``.../part=i``).
* ``wf-align`` — read one segment (selected by ``part=``) of an upstream
  shard output and run the real Smith–Waterman kernel over it.
* ``wf-merge`` — gather any number of upstream outputs and fold them into
  one summary object.

Every executor bumps a shared :class:`ExecutionLog` keyed by job
signature — the ground truth the exactly-once and result-cache tests
assert against (a cached stage never reaches an executor at all).

All executors are idempotent and publish only under their digest-derived
result names, so a stage re-executed after a cluster crash overwrites
byte-identical objects.

The port's copy of ``repro/workflow/apps.py``: the same logic, its imports
pointing inside ``repro_torch``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..core.cluster import ComputeCluster, ExecPlan, ExecResult
from ..core.jobs import INPUTS_FIELD, Job, result_name_for
from ..core.matchmaker import ServiceEndpoint
from ..core.overlay import LidcSystem
from ..core.strategy import Strategy
from ..core.validation import ValidationError, ValidatorRegistry, default_registry
from ..runtime.executors import smith_waterman

__all__ = ["ExecutionLog", "workflow_registry", "workflow_endpoints",
           "build_workflow_fleet", "SHARD_THROUGHPUT", "ALIGN_THROUGHPUT"]

# virtual-time cost model: bytes/second an executor chews through
SHARD_THROUGHPUT = 64 * 2 ** 20
ALIGN_THROUGHPUT = 2 * 2 ** 20
MERGE_BASE_S = 0.05


@dataclass
class ExecutionLog:
    """Ground-truth record of executor invocations, keyed by signature."""

    events: List[Tuple[float, str, str, str]] = field(default_factory=list)
    # (virtual time, app, cluster, job signature)

    def record(self, job: Job, cluster: ComputeCluster, now: float) -> None:
        self.events.append((now, job.spec.app, cluster.name,
                            job.spec.signature()))

    @property
    def total(self) -> int:
        return len(self.events)

    def per_signature(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for _, _, _, sig in self.events:
            out[sig] = out.get(sig, 0) + 1
        return out

    def clusters_used(self) -> List[str]:
        return sorted({c for _, _, c, _ in self.events})

    def reexecuted(self) -> Dict[str, int]:
        """Signatures that ran more than once (crash recovery re-runs)."""
        return {s: n for s, n in self.per_signature().items() if n > 1}


# ---------------------------------------------------------------------------
# executors
# ---------------------------------------------------------------------------

def _require_lake(cluster: ComputeCluster):
    if cluster.lake is None:
        raise RuntimeError("workflow apps need a data lake attached")
    return cluster.lake


def make_shard_executor(log: Optional[ExecutionLog] = None):
    def executor(job: Job, cluster: ComputeCluster) -> ExecPlan:
        lake = _require_lake(cluster)
        if log is not None:
            log.record(job, cluster, cluster.net.now)
        inputs = job.spec.input_names()
        parts = int(job.spec.fields.get("parts", 2))
        rname = result_name_for(job.spec)
        blob = lake.get_bytes(inputs[0])
        if blob is None:
            raise FileNotFoundError(f"dataset {inputs[0]} not in lake")
        duration = max(len(blob) / SHARD_THROUGHPUT, 1e-3)
        sizes: List[int] = []

        def work() -> None:
            step = max(1, -(-len(blob) // parts))   # ceil division
            mv = memoryview(blob)                   # zero-copy sharding
            for i in range(parts):
                seg = mv[i * step:(i + 1) * step]
                sizes.append(len(seg))
                lake.put_bytes(rname.append(f"part={i}"), seg)

        def finalize() -> ExecResult:
            return ExecResult(payload={"app": "wf-shard", "parts": parts,
                                       "input": str(inputs[0]),
                                       "bytes": len(blob), "sizes": sizes},
                              duration=0.0)

        return ExecPlan(phases=[(duration, work)], finalize=finalize)

    return executor


def make_align_executor(log: Optional[ExecutionLog] = None):
    def executor(job: Job, cluster: ComputeCluster) -> ExecPlan:
        lake = _require_lake(cluster)
        if log is not None:
            log.record(job, cluster, cluster.net.now)
        inputs = job.spec.input_names()
        part = int(job.spec.fields.get("part", 0))
        seg_name = inputs[0].append(f"part={part}")
        # zero-copy read: the shard stage published memoryview slices, and
        # numpy consumes the buffer protocol directly — no bytes round-trip
        seg = lake.get_view(seg_name)
        if seg is None:
            raise FileNotFoundError(f"segment {seg_name} not in lake")
        duration = max(len(seg) / ALIGN_THROUGHPUT, 1e-3)
        box: Dict[str, Any] = {}

        def work() -> None:
            # real alignment on a bounded window of the segment vs. a
            # reference derived deterministically from the part index
            reads = np.frombuffer(seg[:64], dtype=np.uint8).astype(np.int64) % 4
            ref = np.random.default_rng(part).integers(0, 4, 64)
            box["score"] = smith_waterman(reads, ref) if len(reads) else 0

        def finalize() -> ExecResult:
            return ExecResult(payload={"app": "wf-align", "part": part,
                                       "score": box.get("score", 0),
                                       "bytes": len(seg)},
                              duration=0.0)

        return ExecPlan(phases=[(duration, work)], finalize=finalize)

    return executor


def make_merge_executor(log: Optional[ExecutionLog] = None):
    def executor(job: Job, cluster: ComputeCluster) -> ExecPlan:
        lake = _require_lake(cluster)
        if log is not None:
            log.record(job, cluster, cluster.net.now)
        inputs = job.spec.input_names()
        payloads: List[Dict[str, Any]] = []

        def work() -> None:
            for n in inputs:
                obj = lake.get_json(n)
                if obj is None:
                    raise FileNotFoundError(f"upstream result {n} not in lake")
                payloads.append(obj)

        def finalize() -> ExecResult:
            scores = [p.get("score", 0) for p in payloads]
            return ExecResult(payload={"app": "wf-merge",
                                       "inputs": len(inputs),
                                       "best_score": max(scores, default=0),
                                       "total_bytes": sum(
                                           int(p.get("bytes", 0))
                                           for p in payloads)},
                              duration=0.0)

        return ExecPlan(phases=[(MERGE_BASE_S, work)], finalize=finalize)

    return executor


# ---------------------------------------------------------------------------
# validators (paper §IV.B: modular, per-application)
# ---------------------------------------------------------------------------

def _validate_inputs(fields: Mapping[str, Any], *, app: str) -> None:
    if not str(fields.get(INPUTS_FIELD, "")):
        raise ValidationError(f"{app} requires in= (data-lake input names)")


def validate_wf_shard(fields, caps) -> None:
    _validate_inputs(fields, app="wf-shard")
    parts = int(fields.get("parts", 0))
    if not (1 <= parts <= 4096):
        raise ValidationError(f"wf-shard parts out of range: {parts}")


def validate_wf_align(fields, caps) -> None:
    _validate_inputs(fields, app="wf-align")
    if int(fields.get("part", -1)) < 0:
        raise ValidationError("wf-align requires part= >= 0")


def validate_wf_merge(fields, caps) -> None:
    _validate_inputs(fields, app="wf-merge")


def workflow_registry(base: Optional[ValidatorRegistry] = None
                      ) -> ValidatorRegistry:
    reg = base or default_registry()
    reg.register("wf-shard", validate_wf_shard)
    reg.register("wf-align", validate_wf_align)
    reg.register("wf-merge", validate_wf_merge)
    return reg


# ---------------------------------------------------------------------------
# fleet assembly
# ---------------------------------------------------------------------------

def workflow_endpoints(log: Optional[ExecutionLog] = None
                       ) -> List[ServiceEndpoint]:
    return [
        ServiceEndpoint(service="wf-shard.lidck8s.svc.cluster.local",
                        app="wf-shard", executor=make_shard_executor(log)),
        ServiceEndpoint(service="wf-align.lidck8s.svc.cluster.local",
                        app="wf-align", executor=make_align_executor(log)),
        ServiceEndpoint(service="wf-merge.lidck8s.svc.cluster.local",
                        app="wf-merge", executor=make_merge_executor(log)),
    ]


def build_workflow_fleet(n_clusters: int = 3, *, chips: int = 4,
                         strategy: Optional[Strategy] = None,
                         latencies: Optional[Sequence[float]] = None,
                         segment_size: Optional[int] = None,
                         engine: str = "calendar"
                         ) -> Tuple[LidcSystem, ExecutionLog]:
    """A LIDC overlay whose clusters serve the workflow apps.

    Returns the system plus the shared :class:`ExecutionLog` — the
    executor-invocation ground truth tests assert exactly-once and
    cache-hit behaviour against.
    """
    system = LidcSystem(strategy=strategy, engine=engine)
    if segment_size is not None:
        system.lake.segment_size = max(1, int(segment_size))
    log = ExecutionLog()
    validators = workflow_registry()
    for i in range(n_clusters):
        lat = latencies[i] if latencies else 0.002 + 0.0005 * i
        system.add_cluster(f"wfpod{i}", chips=chips, latency=lat,
                           endpoints=workflow_endpoints(log),
                           validators=validators)
    return system, log
