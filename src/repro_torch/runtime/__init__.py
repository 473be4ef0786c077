"""The port's side of a LIDC cluster: the executors a cluster calls for
train, serve and blast jobs, the endpoints that carry them, and the
protocol objects they hand over (``protocol``, ``executors``, ``fleet``)."""

from .executors import (HBM_GB_PER_CHIP, blast_executor, make_serve_executor,
                        make_train_executor, memory_model, roofline_step_time)
from .fleet import standard_endpoints
from .protocol import ExecPlan, ExecResult, Job, JobSpec, ServiceEndpoint

__all__ = ["ExecPlan", "ExecResult", "Job", "JobSpec", "ServiceEndpoint",
           "HBM_GB_PER_CHIP", "blast_executor", "make_serve_executor",
           "make_train_executor", "memory_model", "roofline_step_time",
           "standard_endpoints"]
