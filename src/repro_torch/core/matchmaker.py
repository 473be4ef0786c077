"""Matching named jobs to named service endpoints inside a cluster.

This is the K8s half of the paper's design (§III.A-B): once the network has
delivered a compute Interest to a cluster's gateway, the job must be bound
to a *named service endpoint* — the group of pods that actually executes the
application.  Our endpoints carry K8s-style DNS names
(``train-qwen3-1p7b.lidck8s.svc.cluster.local``) and capability sets; the
matchmaker scores candidates on capability fit, resource availability and a
memory model, then grants chips.

The port's copy of ``repro/core/matchmaker.py``: the same logic, its imports
pointing inside ``repro_torch``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Mapping, Optional, Sequence, Tuple

from .jobs import JobSpec

__all__ = ["ServiceEndpoint", "MatchError", "CapacityError", "Matchmaker",
           "HBM_GB_PER_CHIP"]

# an NVIDIA H100 SXM's HBM3, GB: the default size of a chip (the
# reference's default, 16.0, is a TPU v5e's)
HBM_GB_PER_CHIP = 80.0


class MatchError(Exception):
    """No endpoint can run this job here, ever (wrong app/arch/memory)."""


class CapacityError(MatchError):
    """An endpoint *could* run this job, but the cluster is saturated
    (chips busy and the admission queue full).  Gateways answer this with
    a busy receipt carrying an ETA — or shed the work upstream — instead
    of the structural no-capacity Nack."""


# (spec, chips) -> estimated bytes per chip, or None if unknown
MemoryModel = Callable[[JobSpec, int], Optional[float]]


@dataclass
class ServiceEndpoint:
    """A named K8s-service-like executable endpoint."""

    service: str                      # e.g. "train-lm.lidck8s.svc.cluster.local"
    app: str                          # "train" | "serve" | "blast" | ...
    archs: Tuple[str, ...] = ()      # empty = any
    shapes: Tuple[str, ...] = ()     # empty = any
    # model families this endpoint's runtime actually decodes ("dense",
    # "vlm", ...).  Serving endpoints set this from their engine's
    # supported set; the cluster aggregates it into the advertised
    # capability record, so a family the engine would die on is rejected
    # at validation — not at runtime (see repro_torch.serve.engine).
    families: Tuple[str, ...] = ()   # empty = any
    min_chips: int = 1
    max_chips: int = 1 << 20
    executor: Optional[Callable] = None  # (job, cluster) -> (result, duration)
    running: int = 0                  # concurrently bound jobs (load signal)

    def serves(self, spec: JobSpec) -> bool:
        if self.app != spec.app:
            return False
        if self.archs and spec.arch is not None and spec.arch not in self.archs:
            return False
        if self.archs and spec.arch is None:
            return False
        if self.shapes and spec.shape is not None and spec.shape not in self.shapes:
            return False
        return True


class Matchmaker:
    """Bind a validated JobSpec to an endpoint + chip grant.

    ``max_queue_depth`` is the admission-control knob that closes the loop
    with the forwarding strategies: when chips are busy but an endpoint is
    otherwise feasible, up to that many jobs are admitted *queued* (the
    cluster starts them as chips free up); past it the matchmaker raises,
    the gateway NACKs, the NACK raises the upstream nexthop's loss EWMA,
    and the adaptive strategy diverts subsequent Interests to a less
    congested cluster — decentralized backpressure, no controller.
    """

    def __init__(self, memory_model: Optional[MemoryModel] = None,
                 hbm_gb_per_chip: float = HBM_GB_PER_CHIP, max_queue_depth: int = 0):
        self.memory_model = memory_model
        self.hbm_bytes_per_chip = hbm_gb_per_chip * 1e9
        self.max_queue_depth = max_queue_depth

    def _feasible(self, spec: JobSpec, candidates: Sequence[ServiceEndpoint],
                  chip_budget: int, want: int,
                  eta_fn: Optional[Callable[[ServiceEndpoint, int], float]]
                  = None) -> List[Tuple[float, ServiceEndpoint, int]]:
        feasible: List[Tuple[float, ServiceEndpoint, int]] = []
        for e in candidates:
            grant = min(want, e.max_chips)
            if grant < e.min_chips or grant > chip_budget:
                continue
            if self.memory_model is not None:
                est = self.memory_model(spec, grant)
                if est is not None and est > self.hbm_bytes_per_chip:
                    # try scaling chips up to fit memory, within the request
                    fitted = None
                    g = grant
                    while g * 2 <= min(chip_budget, e.max_chips, max(want, 1) * 8):
                        g *= 2
                        est2 = self.memory_model(spec, g)
                        if est2 is not None and est2 <= self.hbm_bytes_per_chip:
                            fitted = g
                            break
                    if fitted is None:
                        continue
                    grant = fitted
            # score: prefer the endpoint predicted to complete soonest
            # (eta_fn, when the compute plane supplies one) or, without a
            # predictor, least-loaded; most-specific arch match breaks ties
            load = eta_fn(e, grant) if eta_fn is not None else float(e.running)
            specificity = (1 if e.archs else 0) + (1 if e.shapes else 0)
            feasible.append((load - 0.1 * specificity, e, grant))
        return feasible

    def match(self, spec: JobSpec, endpoints: Sequence[ServiceEndpoint],
              free_chips: int, *, queue_depth: int = 0,
              total_chips: Optional[int] = None,
              advertised: Optional[Mapping] = None,
              eta_fn: Optional[Callable[[ServiceEndpoint, int], float]] = None
              ) -> Tuple[ServiceEndpoint, int]:
        """Pick (endpoint, chip grant) for a job.

        The returned grant may exceed ``free_chips`` when queued admission
        applies (``queue_depth < max_queue_depth`` and the job fits the
        cluster's *total* capacity) — the caller queues such jobs.

        ``advertised`` is the cluster's capability record as gossiped by
        the routing protocol; when present it caps both budgets, so a
        cluster that advertised fewer chips than it physically has never
        grants past its advertisement.  ``eta_fn(endpoint, grant)`` — the
        compute plane's predicted completion — replaces the raw running
        count in endpoint scoring when provided.

        Raises :class:`CapacityError` (a :class:`MatchError`) when an
        endpoint could serve the job but the cluster is saturated, and a
        plain :class:`MatchError` when nothing here could ever run it.
        """
        if advertised is not None and "chips" in advertised:
            adv_chips = int(advertised["chips"])
            used = max(0, (total_chips or free_chips) - free_chips)
            free_chips = max(0, min(free_chips, adv_chips - used))
            if total_chips is not None:
                total_chips = min(total_chips, adv_chips)
        candidates = [e for e in endpoints if e.serves(spec)]
        if not candidates:
            raise MatchError(f"no endpoint serves app={spec.app} "
                             f"arch={spec.arch} shape={spec.shape}")
        want = spec.chips(default=1)
        feasible = self._feasible(spec, candidates, free_chips, want, eta_fn)
        if not feasible:
            # one total-budget pass serves both queued admission and the
            # saturated-vs-structural classification below
            budget = total_chips if total_chips is not None else free_chips
            total_feasible = self._feasible(spec, candidates, budget, want,
                                            eta_fn)
            if queue_depth < self.max_queue_depth:
                feasible = total_feasible
            if not feasible:
                msg = (f"no feasible endpoint for {spec.app}/{spec.arch} "
                       f"(want {want} chips, free {free_chips}, "
                       f"queued {queue_depth}/{self.max_queue_depth})")
                if total_feasible:
                    # the job fits the cluster's *total* budget: only the
                    # current load stands in the way
                    raise CapacityError(msg)
                raise MatchError(msg)
        feasible.sort(key=lambda t: (t[0], t[1].service))
        _, endpoint, grant = feasible[0]
        return endpoint, grant
