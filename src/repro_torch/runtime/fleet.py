"""A cluster's endpoints when its executors are the port's, ported from
``repro/runtime/fleet.py::standard_endpoints``.

The overlay is the reference's (``repro.core.overlay.LidcSystem``), built by
the host program; an H100 cluster joins it with these endpoints beside
clusters whose endpoints are the reference's::

    from repro.core.cluster import ExecPlan, ExecResult
    from repro_torch.runtime import HBM_GB_PER_CHIP, memory_model, standard_endpoints

    system.add_cluster("h100", chips=1, hbm_gb_per_chip=HBM_GB_PER_CHIP,
                       memory_model=memory_model,
                       endpoints=standard_endpoints(archs, plan_type=ExecPlan,
                                                    result_type=ExecResult))

Each endpoint lists only the archs whose resolved family the port runs for
its app, so the overlay places the other archs on other clusters.
"""

from __future__ import annotations

from typing import Collection, List, Sequence

from ..configs.base import SHAPES
from ..models.model import PORTED_FAMILIES, TRAINED_FAMILIES
from ..serve.engine import SUPPORTED_FAMILIES
from .executors import (REAL_PARAM_LIMIT, _resolve_arch, blast_executor,
                        make_serve_executor, make_train_executor)
from .protocol import ExecPlan, ExecResult, ServiceEndpoint

__all__ = ["standard_endpoints"]


def _runs(arch: str, families: Collection[str]) -> bool:
    """Whether ``arch`` resolves (as the executors resolve it) to a config
    of one of ``families``."""
    try:
        return _resolve_arch(arch).family in families
    except (KeyError, ModuleNotFoundError):
        return False


def standard_endpoints(archs: Sequence[str], *, ckpt_every: int = 10, device=None,
                       plan_type=ExecPlan, result_type=ExecResult,
                       real_param_limit: int = REAL_PARAM_LIMIT) -> List[ServiceEndpoint]:
    """The train, serve and blast endpoints of one cluster, as the
    reference's: train takes the archs of the families the port trains,
    serve those of every family it runs (serving the ones its engine does
    not decode as simulated jobs, as the reference does).  An app none of
    whose archs the port runs gets no endpoint."""
    shapes = tuple(SHAPES) + ("custom",)
    train_archs = tuple(a for a in archs if _runs(a, TRAINED_FAMILIES))
    serve_archs = tuple(a for a in archs if _runs(a, PORTED_FAMILIES))
    endpoints = [
        ServiceEndpoint(service="train-lm.lidck8s.svc.cluster.local", app="train",
                        archs=train_archs, shapes=shapes,
                        executor=make_train_executor(ckpt_every=ckpt_every, device=device,
                                                     plan_type=plan_type,
                                                     result_type=result_type,
                                                     real_param_limit=real_param_limit)),
        ServiceEndpoint(service="serve-lm.lidck8s.svc.cluster.local", app="serve",
                        archs=serve_archs, shapes=shapes, families=SUPPORTED_FAMILIES,
                        executor=make_serve_executor(device=device, result_type=result_type,
                                                     real_param_limit=real_param_limit)),
        ServiceEndpoint(service="magicblast.lidck8s.svc.cluster.local", app="blast",
                        executor=blast_executor),
    ]
    # an endpoint with no archs would take any arch: leave it out instead
    return [e for e in endpoints if e.app == "blast" or e.archs]
