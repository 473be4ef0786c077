"""Fleet assembly, ported from ``repro/runtime/fleet.py``: the endpoints of
a cluster whose executors are the port's, and a LIDC overlay of such
clusters built from the port's own control plane (``repro_torch.core``).

``build_fleet`` gives N clusters of H100s, each with train, serve and blast
endpoints for the archs it hosts, all announced into one overlay;
``resilient_run`` drives a named job to completion across cluster failures.
Every cluster's chips are 80 GB, and ``memory_model`` sizes its jobs::

    from repro_torch.runtime.fleet import build_fleet

    system = build_fleet(3, chips=16, archs=["lidc-demo"], device="cuda")
    handle = system.client.run_job({"app": "train", "arch": "lidc-demo",
                                    "shape": "custom", "chips": 4, "steps": 15})

An H100 cluster can also join the reference's overlay
(``repro.core.overlay.LidcSystem``) beside clusters whose endpoints are the
reference's, with the host's protocol classes::

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

from typing import Collection, Dict, List, Optional, Sequence

from ..configs.base import SHAPES, registry
from ..core.overlay import LidcSystem
from ..core.strategy import Strategy
from ..models.model import PORTED_FAMILIES, TRAINED_FAMILIES
from ..serve.engine import SUPPORTED_FAMILIES
from .executors import (REAL_PARAM_LIMIT, _resolve_arch, blast_executor,
                        make_serve_executor, make_train_executor, memory_model)
from .protocol import ExecPlan, ExecResult, ServiceEndpoint

__all__ = ["standard_endpoints", "build_fleet", "resilient_run"]


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


def build_fleet(n_clusters: int = 3, *, chips: int = 256,
                archs: Optional[Sequence[str]] = None,
                latencies: Optional[Sequence[float]] = None,
                strategy: Optional[Strategy] = None,
                ckpt_every: int = 10, device=None) -> LidcSystem:
    """A LIDC overlay with ``n_clusters`` identical H100 clusters of
    ``chips`` cards, built as the reference builds its TPU pods: each hosts
    ``archs`` (every registry arch by default), their smoke configs and
    ``lidc-demo``.  ``device`` is where the executors compute: the card
    unless the caller says ``"cpu"``."""
    archs = list(archs) if archs is not None else list(registry())
    archs += [a + "-smoke" for a in list(archs)] + ["lidc-demo"]
    sys_ = LidcSystem(strategy=strategy)
    for i in range(n_clusters):
        lat = latencies[i] if latencies else 0.002 * (i + 1)
        sys_.add_cluster(f"pod{i}", chips=chips, latency=lat,
                         endpoints=standard_endpoints(archs, ckpt_every=ckpt_every,
                                                      device=device),
                         memory_model=memory_model)
    return sys_


def resilient_run(sys_: LidcSystem, fields: Dict, *, max_attempts: int = 4,
                  poll_interval: float = 1.0):
    """Submit a job and drive it to completion across failures: each
    attempt is the plain client workflow; if the serving cluster dies
    mid-run, the client expresses the same canonical name again, the
    overlay routes it to a surviving cluster, and that cluster resumes from
    the named checkpoint.  Returns the last handle and the attempts made."""
    last = None
    for attempt in range(max_attempts):
        handle = sys_.client.run_job(fields, interval=poll_interval)
        last = handle
        if handle is not None and handle.state == "Completed":
            return handle, attempt + 1
    return last, max_attempts
