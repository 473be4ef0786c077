"""LIDC core: the paper's decentralized, name-based control plane, the
port's copy of ``repro/core``: plain Python, no tensors."""

from .names import (COMPUTE_PREFIX, DATA_PREFIX, STATUS_PREFIX, Name,
                    canonical_job_name, encode_job, job_fields_of, parse_job)
from .packets import Data, Interest, sign_data, verify_data
from .demand import DemandTracker
from .tables import ContentStore, Fib, LinearFib, NextHop, Pit, Rib, RibRoute
from .forwarder import Consumer, Forwarder, Nack, Network, link
from .routing import RoutingAgent, RoutingConfig, capability_cost
from .strategy import (AdaptiveStrategy, BestRouteStrategy,
                       CompletionTimeStrategy, LoadShareStrategy,
                       MulticastStrategy, Strategy)
from .jobs import Job, JobSpec, JobState, result_name_for
from .validation import ValidationError, ValidatorRegistry, default_registry
from .matchmaker import CapacityError, MatchError, Matchmaker, ServiceEndpoint
from .cluster import ComputeCluster, ExecPlan, ExecResult
from .compute_plane import ClusterScheduler, SchedulerConfig
from .gateway import Gateway
from . import reasons
from .overlay import (JobHandle, LidcClient, LidcSystem, MeshTopology,
                      Overlay)
from .scheduler import CompletionModel

__all__ = [
    "Name", "canonical_job_name", "encode_job", "parse_job", "job_fields_of",
    "COMPUTE_PREFIX", "DATA_PREFIX", "STATUS_PREFIX",
    "Data", "Interest", "sign_data", "verify_data", "DemandTracker",
    "ContentStore", "Fib", "LinearFib", "NextHop", "Pit", "Rib", "RibRoute",
    "Consumer", "Forwarder", "Nack", "Network", "link",
    "RoutingAgent", "RoutingConfig", "capability_cost",
    "Strategy", "AdaptiveStrategy", "BestRouteStrategy", "LoadShareStrategy",
    "MulticastStrategy",
    "CompletionTimeStrategy", "CompletionModel",
    "Job", "JobSpec", "JobState", "result_name_for",
    "ValidationError", "ValidatorRegistry", "default_registry",
    "CapacityError", "MatchError", "Matchmaker", "ServiceEndpoint",
    "ComputeCluster", "ExecPlan", "ExecResult", "Gateway",
    "ClusterScheduler", "SchedulerConfig", "reasons",
    "JobHandle", "LidcClient", "LidcSystem", "MeshTopology", "Overlay",
]
