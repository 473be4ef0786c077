"""The hand-offs between a LIDC cluster and its executors.

A cluster binds a job to a ``ServiceEndpoint`` and calls its executor with
the job and itself; the executor returns an ``ExecResult`` or a phased
``ExecPlan``.  Each is defined once, in the port's control plane
(``core/cluster.py``, ``core/matchmaker.py``, ``core/jobs.py``,
``core/names.py``), and re-exported here for the executors.

A cluster tells a plan from a result with ``isinstance`` against its own
``ExecPlan``, so the executors build the port's classes by default; an
executor that runs in a reference cluster (``repro.core``) is given the
host's classes as ``plan_type`` and ``result_type``
(``runtime/executors.py``).  ``JobSpec.signature()`` is the reference's,
byte for byte: a run named ``train-<signature>`` by the port is the run a
reference cluster names so, and either framework finds the other's
checkpoints under it.
"""

from __future__ import annotations

from ..core.cluster import ExecPlan, ExecResult
from ..core.jobs import TRANSPORT_FIELDS, Job, JobSpec
from ..core.matchmaker import ServiceEndpoint
from ..core.names import COMPUTE_PREFIX, canonical_job_name, encode_job

__all__ = ["ExecResult", "ExecPlan", "ServiceEndpoint", "JobSpec", "Job",
           "COMPUTE_PREFIX", "TRANSPORT_FIELDS", "encode_job", "canonical_job_name"]
