"""The hand-offs between a LIDC cluster and its executors, the port's own
copies.

A cluster binds a job to a ``ServiceEndpoint`` and calls its executor with
the job and itself; the executor returns an ``ExecResult`` or a phased
``ExecPlan``.  The fields are those of the reference's
``repro/core/cluster.py`` (``ExecResult``, ``ExecPlan``) and
``repro/core/matchmaker.py`` (``ServiceEndpoint``), so a reference cluster
reads the port's objects by their attributes.  It tells a plan from a result
with ``isinstance`` against its own ``ExecPlan``, so an executor that runs in
a reference cluster must build the host's plan type: the executor factories
take it as ``plan_type`` (``runtime/executors.py``).

``JobSpec`` and ``Job`` are the part of the reference's jobs that an
executor reads: the application, the fields, the granted chips and the
signature, computed as the reference computes it (``repro/core/jobs.py``
over ``repro/core/names.py``'s canonical job name).  A run named
``train-<signature>`` by the port is the run a reference cluster names so,
and either framework finds the other's checkpoints under it.
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from ..lake import LakeName

__all__ = ["ExecResult", "ExecPlan", "ServiceEndpoint", "JobSpec", "Job",
           "COMPUTE_PREFIX", "TRANSPORT_FIELDS", "encode_job", "canonical_job_name"]

COMPUTE_PREFIX = "/lidc/compute"

# fields that steer where a request runs (the spill path, the speculation
# avoid list), not what it computes: left out of the signature
TRANSPORT_FIELDS = frozenset({"spill", "avoid"})


@dataclass
class ExecResult:
    """What an executor returns: the result payload and its virtual
    duration (seconds on the overlay's clock)."""

    payload: Dict[str, Any]
    duration: float
    arrays: Optional[Dict[str, Any]] = None  # large outputs -> lake arrays


@dataclass
class ExecPlan:
    """Phased execution: ``[(virtual_duration, work_fn), ...]`` and a
    ``finalize`` that returns the ``ExecResult``.  Each phase's work ends in
    a named checkpoint, so a cluster that dies between phases loses at most
    one phase."""

    phases: List[Tuple[float, Callable[[], None]]]
    finalize: Callable[[], ExecResult]


@dataclass
class ServiceEndpoint:
    """A named, K8s-service-like endpoint: the app it runs, the archs and
    shapes it accepts (empty: any), the model families its engine decodes
    (serving endpoints; empty: any), its chip range and its executor."""

    service: str
    app: str
    archs: Tuple[str, ...] = ()
    shapes: Tuple[str, ...] = ()
    families: Tuple[str, ...] = ()
    min_chips: int = 1
    max_chips: int = 1 << 20
    executor: Optional[Callable] = None  # (job, cluster) -> ExecResult | plan
    running: int = 0                     # concurrently bound jobs

    def serves(self, spec) -> bool:
        if self.app != spec.app:
            return False
        if self.archs and (spec.arch is None or spec.arch not in self.archs):
            return False
        if self.shapes and spec.shape is not None and spec.shape not in self.shapes:
            return False
        return True


_JOB_KEY_RE = re.compile(r"^[A-Za-z0-9_.\-]+$")


def _encode_value(v: Any) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


def encode_job(fields: Mapping[str, Any]) -> str:
    """The canonical ``k=v&k=v`` component: keys sorted, so identical
    requests give identical names."""
    parts = []
    for k, v in sorted(fields.items()):
        if not _JOB_KEY_RE.match(k):
            raise ValueError(f"illegal job field key {k!r}")
        parts.append(f"{k}={_encode_value(v)}")
    return "&".join(parts)


def canonical_job_name(fields: Mapping[str, Any]) -> LakeName:
    """``/lidc/compute/<app>[/<arch>[/<shape>]]/[k=v&...]``: the well-known
    fields as components, the rest as one canonical tail."""
    f = dict(fields)
    if "app" not in f:
        raise ValueError("job description requires an 'app' field")
    name = LakeName.parse(COMPUTE_PREFIX).append(str(f.pop("app")))
    arch = f.pop("arch", None)
    shape = f.pop("shape", None)
    if arch is not None:
        name = name.append(str(arch))
        if shape is not None:
            name = name.append(str(shape))
    elif shape is not None:
        f["shape"] = shape   # a shape without an arch stays in the tail
    if f:
        name = name.append(encode_job(f))
    return name


@dataclass(frozen=True)
class JobSpec:
    """A job description: its app and its fields (values as given)."""

    app: str
    fields: Dict[str, Any] = field(default_factory=dict)

    @property
    def arch(self) -> Optional[str]:
        return self.fields.get("arch")

    @property
    def shape(self) -> Optional[str]:
        return self.fields.get("shape")

    def steps(self, default: int = 1) -> int:
        return int(self.fields.get("steps", default))

    def signature(self) -> str:
        """The identity of the work: the first 16 hex digits of the SHA-256
        of the canonical name, transport fields left out."""
        fields = {k: v for k, v in self.fields.items() if k not in TRANSPORT_FIELDS}
        name = canonical_job_name({"app": self.app, **fields})
        return hashlib.sha256(str(name).encode()).hexdigest()[:16]


@dataclass
class Job:
    """A job as an executor sees it: its spec and the chips granted."""

    spec: JobSpec
    granted_chips: int = 1
