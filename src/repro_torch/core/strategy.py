"""Forwarding strategies — how the network *chooses the cluster*.

This is the heart of the paper's claim: once clusters announce semantic
prefixes, "the network can bring the compute request to the nearest (or
the best) compute cluster" (paper §III.B).  The strategy is the policy
point where that choice is made:

* :class:`BestRouteStrategy` — lowest cost nexthop; on retransmission it
  rotates to the next-best (this is what yields failover).
* :class:`LoadShareStrategy` — deterministic weighted round-robin over
  healthy nexthops (the paper's load-balancing capability).
* :class:`MulticastStrategy` — send to k upstreams at once; with PIT
  dedup of the returning Data this is the straggler-mitigation primitive
  (first cluster to answer wins; duplicates are suppressed).
* :class:`AdaptiveStrategy` — congestion/RTT-aware: ranks next-hops by an
  exponentially-weighted RTT inflated by observed loss (Data vs Nack /
  timeout outcomes) and outstanding-interest pressure; on *cold* prefixes
  (no measurements yet) it parallel-probes several upstreams and lets the
  first Data teach it the ranking.
* :class:`CompletionTimeStrategy` — the paper's §VII future-work
  "intelligence in the network": rank clusters by a learned
  completion-time model (see core/scheduler.py) fed by Table-I-style
  observations, now blended with the transport telemetry the adaptive
  layer collects.

Strategies receive *feedback*: the forwarder calls :meth:`Strategy.feedback`
for every Data (ok=True, with the measured RTT) and Nack (ok=False) that
resolves a pending Interest, after updating the per-nexthop moving stats
on the FIB leaf.  Stateless strategies ignore it; learning strategies
(adaptive, completion-time) consume it.

The port's copy of ``repro/core/strategy.py``: the same logic, its imports
pointing inside ``repro_torch``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .names import Name, job_fields_of
from .packets import Interest
from .resilience import CircuitBreaker
from .tables import NextHop, PitEntry

__all__ = [
    "Strategy",
    "BestRouteStrategy",
    "LoadShareStrategy",
    "MulticastStrategy",
    "AdaptiveStrategy",
    "CompletionTimeStrategy",
]


class Strategy:
    def choose(self, interest: Interest, entry: PitEntry,
               nexthops: List[NextHop], now: float) -> List[NextHop]:
        raise NotImplementedError

    def feedback(self, name: Name, face_id: int, ok: bool, rtt: float,
                 now: float) -> None:
        """Outcome notification for a previously-forwarded Interest.

        Called by the forwarder when Data (``ok=True``, with measured RTT)
        or a Nack (``ok=False``) resolves a PIT entry.  Default: no-op.
        """


class BestRouteStrategy(Strategy):
    """Lowest-cost upstream; retransmissions probe the next-best path."""

    def choose(self, interest, entry, nexthops, now):
        # hot path (default strategy, runs once per Interest per hop): a
        # single scan for the best untried hop — falling back to the best
        # tried one — replaces sort + two list builds per decision
        out_faces = entry.out_faces
        best = fallback = None
        best_key = fb_key = None
        for h in nexthops:
            k = (h.cost, h.rtt_ewma or 1e9, h.face_id)
            if h.face_id not in out_faces:
                if best_key is None or k < best_key:
                    best, best_key = h, k
            elif fb_key is None or k < fb_key:
                fallback, fb_key = h, k
        return [best if best is not None else fallback]


class LoadShareStrategy(Strategy):
    """Deterministic weighted round-robin (weight = 1/cost)."""

    def __init__(self) -> None:
        self._credit: Dict[int, float] = {}

    def choose(self, interest, entry, nexthops, now):
        best: Optional[NextHop] = None
        best_credit = float("-inf")
        for h in nexthops:
            c = self._credit.get(h.face_id, 0.0) + 1.0 / max(h.cost, 1e-6)
            self._credit[h.face_id] = c
            if c > best_credit:
                best, best_credit = h, c
        assert best is not None
        self._credit[best.face_id] -= sum(1.0 / max(h.cost, 1e-6) for h in nexthops)
        return [best]


class MulticastStrategy(Strategy):
    """Fan an Interest to up to ``k`` upstreams; first Data wins.

    With PIT aggregation, the duplicate answers are dropped at the join
    point — so duplicating work to 2 clusters costs bandwidth but bounds
    tail latency by the *fastest* cluster: straggler mitigation at the
    control plane, no coordination required.
    """

    def __init__(self, k: int = 2) -> None:
        self.k = k

    def choose(self, interest, entry, nexthops, now):
        ranked = sorted(nexthops, key=lambda h: (h.cost, h.face_id))
        return ranked[: self.k]


class AdaptiveStrategy(Strategy):
    """Congestion/RTT-aware ranking learned from Data/Nack outcomes.

    Each FIB leaf's :class:`~repro_torch.core.tables.NextHop` carries an EWMA
    RTT, an EWMA loss rate and an outstanding-interest counter, all kept
    current by the forwarder's measurement feedback.  The strategy ranks
    next-hops by :meth:`NextHop.score` — EWMA RTT inflated by loss and
    pressure — so an upstream that starts NACKing or timing out decays
    out of the top slot within a handful of interests, and recovers the
    same way (the EWMA forgets).

    Cold prefixes (no measured next-hop yet) are *parallel-probed*: the
    Interest fans to up to ``probe_fanout`` upstreams at once; PIT dedup
    keeps duplicate answers from propagating, and the first Data seeds
    the RTT ranking.  Every ``explore_every``-th decision additionally
    tries the best unmeasured hop alongside the incumbent, so newly
    announced routes get discovered without randomness (the virtual clock
    stays deterministic).

    ``rotate_cold_probes`` spreads *concurrent* cold prefixes across
    upstreams: each successive cold probe starts its fanout window at the
    next offset in the cost ranking instead of always at the cheapest.
    A scatter stage of a workflow (N sibling names expressed at once, all
    cold) then lands on N different clusters instead of piling onto the
    two cheapest — deterministic placement spread with no coordinator.
    Off by default: single-job workloads want the cheapest upstreams.

    FIB costs are no longer static announcement hop counts: the routing
    protocol derives them from *advertised* cost — path length plus the
    origin's capability penalty (a cluster that advertised no free chips
    or a deep admission queue costs more; see
    :func:`repro_torch.core.routing.capability_cost`).  Cold-prefix probing
    ranks by that cost, so the very first Interest for a prefix is seeded
    toward the cluster that advertised spare capacity.  ``cost_bias``
    additionally folds the advertised cost into the *measured* ranking
    (score × (1 + cost_bias × (cost − 1))), so a capability downgrade
    gossiped mid-run steers warm traffic too; 0 keeps the historical
    pure-telemetry ranking.

    ``eta_weight`` makes the ranking *completion-aware*: a saturated
    gateway's busy receipt quotes its predicted completion time, the
    forwarder folds the quote into the nexthop's ``eta_ewma``, and the
    ranking adds ``eta_weight x eta`` seconds to that upstream's score —
    so the strategy weighs transfer cost (RTT) *plus predicted
    completion*, not hop cost alone, and a cluster that stops quoting
    (the ETA decays on every success) wins traffic back.  0 (default)
    keeps the historical transport-only ranking.

    ``split_segments`` (on by default) is the bulk-data fast path: an
    Interest whose final component is ``seg=i`` belongs to a windowed
    object fetch, and is steered to the *least-loaded* upstream — argmin
    of (outstanding interests, score) — instead of probed/fanned out.
    With several clusters announcing the same data prefix, a consumer's
    congestion window naturally splits across the replicas: every
    in-flight segment bumps its upstream's ``pending`` counter, so the
    next segment goes wherever capacity is free, and a slow replica
    (pending drains slower) organically receives fewer segments.
    """

    def __init__(self, probe_fanout: int = 2, explore_every: int = 16,
                 loss_weight: float = 8.0,
                 rotate_cold_probes: bool = False,
                 split_segments: bool = True,
                 cost_bias: float = 0.0,
                 eta_weight: float = 0.0,
                 breaker: Optional[CircuitBreaker] = None) -> None:
        self.probe_fanout = max(1, probe_fanout)
        self.explore_every = max(2, explore_every)
        self.loss_weight = loss_weight
        self.rotate_cold_probes = rotate_cold_probes
        self.split_segments = split_segments
        self.cost_bias = cost_bias
        self.eta_weight = eta_weight
        # optional per-upstream circuit breaker (core/resilience.py): a
        # face that fails `fail_threshold` times in a row is quarantined —
        # filtered out of every choice — until its cooloff admits one
        # half-open probe; a success closes the circuit.  None (default)
        # keeps the historical EWMA-only behavior.
        self.breaker = breaker
        self._decisions = 0
        self.probes = 0
        self.explorations = 0
        self.segment_splits = 0
        self.quarantine_skips = 0
        self.breaker_probes = 0

    def feedback(self, name, face_id, ok, rtt, now):
        if self.breaker is not None:
            self.breaker.record(face_id, ok, now)

    def _admit(self, nexthops: List[NextHop], now: float) -> List[NextHop]:
        """Drop quarantined upstreams — unless that would leave nothing,
        in which case all hops stay eligible (an open circuit must never
        black-hole the only route)."""
        if self.breaker is None:
            return nexthops
        allowed = [h for h in nexthops if self.breaker.allow(h.face_id, now)]
        if allowed and len(allowed) < len(nexthops):
            self.quarantine_skips += len(nexthops) - len(allowed)
        return allowed or nexthops

    def _rank(self, nexthops: List[NextHop]) -> List[NextHop]:
        return sorted(
            nexthops,
            key=lambda h: (h.score(loss_weight=self.loss_weight)
                           * (1.0 + self.cost_bias * max(h.cost - 1.0, 0.0))
                           + self.eta_weight * h.eta_ewma,
                           h.cost, h.face_id))

    def choose(self, interest, entry, nexthops, now):
        self._decisions += 1
        nexthops = self._admit(nexthops, now)
        if self.breaker is not None:
            # a half-open circuit means _admit just granted that upstream
            # its probe window: route this interest through it *alone* so
            # the probe gets an unambiguous verdict (a piggy-backed probe
            # that loses a same-round race resolves with no verdict and
            # the circuit never closes).  If the probe fails, NACK
            # failover / retransmission recovers the request on the
            # remaining upstreams.
            probe = min((h for h in nexthops
                         if h.face_id not in entry.out_faces
                         and self.breaker.state(h.face_id) == "half-open"),
                        key=lambda h: (h.cost, h.face_id), default=None)
            if probe is not None:
                self.breaker_probes += 1
                return [probe]
        comps = interest.name.components
        if (self.split_segments and comps and comps[-1].startswith("seg=")
                and len(nexthops) > 1):
            # bulk segment: single upstream, least outstanding work first —
            # the congestion window spreads itself across the replicas
            self.segment_splits += 1
            return [min(nexthops,
                        key=lambda h: (h.pending,
                                       h.score(loss_weight=self.loss_weight),
                                       h.cost, h.face_id))]
        measured = [h for h in nexthops if h.measured]
        if not measured:
            # cold prefix: parallel probe the cheapest upstreams; with
            # rotation, each successive cold probe starts one slot later
            # so concurrent scatter siblings spread across clusters
            self.probes += 1
            ranked = sorted(nexthops, key=lambda h: (h.cost, h.face_id))
            k = min(self.probe_fanout, len(ranked))
            if self.rotate_cold_probes and len(ranked) > k:
                start = ((self.probes - 1) * k) % len(ranked)
                return [ranked[(start + j) % len(ranked)] for j in range(k)]
            return ranked[:k]
        ranked = self._rank(measured)
        untried = [h for h in ranked if h.face_id not in entry.out_faces]
        best = untried[0] if untried else ranked[0]
        chosen = [best]
        # exploration: co-probe the least-recently-used alternative so new
        # routes get discovered and degraded ones get a chance to recover —
        # immediately when the incumbent itself looks unhealthy, otherwise
        # on a deterministic cadence (the virtual clock stays reproducible)
        alternates = [h for h in nexthops
                      if h.face_id != best.face_id
                      and h.face_id not in entry.out_faces]
        if alternates and (best.loss_ewma > 0.5
                           or self._decisions % self.explore_every == 0):
            self.explorations += 1
            chosen.append(min(alternates,
                              key=lambda h: (h.last_used, h.cost, h.face_id)))
        return chosen


class CompletionTimeStrategy(Strategy):
    """Rank clusters by predicted completion time for *this job name*.

    The predictor (core/scheduler.CompletionModel) learns per
    (app, arch, shape) from observed run times — the "deploy intelligence
    in the network ... learn from this data and pick the optimal
    configuration" loop the paper sketches from its Table I.  Predictions
    are inflated by the transport-level loss the adaptive layer observes
    (a fast cluster behind a flapping link is not fast).
    """

    def __init__(self, model, fallback: Optional[Strategy] = None) -> None:
        self.model = model
        self.fallback = fallback or AdaptiveStrategy()

    def feedback(self, name, face_id, ok, rtt, now):
        # teach the completion model about transport health, and pass the
        # signal through to the fallback in case it learns too
        observe = getattr(self.model, "observe_transport", None)
        if observe is not None:
            observe(face_id, ok, rtt)
        self.fallback.feedback(name, face_id, ok, rtt, now)

    def choose(self, interest, entry, nexthops, now):
        fields = job_fields_of(interest.name)
        if not fields:
            return self.fallback.choose(interest, entry, nexthops, now)
        scored: List[Tuple[float, NextHop]] = []
        for h in nexthops:
            pred = self.model.predict(fields, face_id=h.face_id)
            if pred is None:
                pred = h.rtt_ewma if h.rtt_ewma > 0 else 1e6 + h.cost
            penalty = getattr(self.model, "transport_penalty", None)
            if penalty is not None:
                pred *= penalty(h.face_id)
            scored.append((pred + h.rtt_ewma * 0.1, h))
        scored.sort(key=lambda t: (t[0], t[1].face_id))
        untried = [h for _, h in scored if h.face_id not in entry.out_faces]
        return [untried[0] if untried else scored[0][1]]
