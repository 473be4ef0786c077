"""Named workflow DAGs over the data lake, driven through the forwarder.

See :mod:`repro_torch.workflow.dag` (the DAG model), :mod:`.engine` (the
client-side execution engine), :mod:`.apps` (shard/align/merge stage
applications + fleet assembly) and :mod:`.faults` (deterministic fault
injection for the end-to-end tests).

The port's copy of ``repro/workflow/__init__.py``: the same logic, its imports
pointing inside ``repro_torch``.
"""

from .dag import (StageInstance, StageSpec, Workflow, WorkflowError,
                  WorkflowSpec)
from .engine import StageStatus, WorkflowEngine, WorkflowRun
from .faults import FaultInjector

__all__ = [
    "StageInstance",
    "StageSpec",
    "StageStatus",
    "Workflow",
    "WorkflowEngine",
    "WorkflowError",
    "WorkflowRun",
    "WorkflowSpec",
    "FaultInjector",
]
