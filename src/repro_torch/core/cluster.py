"""ComputeCluster: a pod of accelerators (H100s in the port) with a gateway node,
endpoints and a job runtime.

One ComputeCluster is the analog of one MicroK8s cluster in the paper:
a gateway forwarder (the paper's gateway-NFD pod), a set of named service
endpoints, a chip-capacity accountant, and a connection to the data lake.
Job execution is pluggable: tests run *real* JAX steps on tiny configs;
benchmarks use a calibrated cost model so the virtual clock reflects
Table-I-style run times without hours of wall time.

The admit→queue→execute→complete lifecycle lives in the cluster's
:class:`~repro_torch.core.compute_plane.ClusterScheduler` (priority classes,
phase-boundary preemption, ETA-aware admission, starvation-free
backfill); this class keeps the capability accounting, the advertised
record the routing protocol gossips, and failure injection.

The port's copy of ``repro/core/cluster.py``: the same logic, its imports
pointing inside ``repro_torch``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from .compute_plane import ClusterScheduler, SchedulerConfig
from .forwarder import Forwarder, Network
from .jobs import Job, JobSpec
from .matchmaker import HBM_GB_PER_CHIP, Matchmaker, ServiceEndpoint
from .names import (BATCH_PREFIX, COMPUTE_PREFIX, DATA_PREFIX, SERVE_PREFIX,
                    STATUS_PREFIX, Name)

__all__ = ["ComputeCluster", "ExecResult", "ExecPlan"]


@dataclass
class ExecResult:
    """What an executor returns: result payload + virtual duration."""

    payload: Dict[str, Any]
    duration: float
    arrays: Optional[Dict[str, Any]] = None  # large outputs -> lake arrays


@dataclass
class ExecPlan:
    """Phased execution: [(virtual_duration, work_fn), ...] + finalize.

    Each phase's ``work_fn`` performs that phase's real side effects
    (train steps + checkpoint into the lake).  If the cluster dies between
    phases, completed phases' checkpoints survive — a retransmitted job
    resumes from them on another cluster.  Phase boundaries are also the
    scheduler's *preemption points*: a preempted job releases its chips at
    the next boundary and later resumes from exactly this position.
    """

    phases: List[Tuple[float, Callable[[], None]]]
    finalize: Callable[[], ExecResult]


# executor(job, cluster) -> ExecResult | ExecPlan ; may raise to fail the job
Executor = Callable[[Job, "ComputeCluster"], ExecResult]


class ComputeCluster:
    def __init__(self, net: Network, name: str, *, chips: int = 256,
                 hbm_gb_per_chip: float = HBM_GB_PER_CHIP, lake=None,
                 memory_model=None, region: str = "local",
                 strategy=None, max_queue_depth: int = 0,
                 scheduler_config: Optional[SchedulerConfig] = None,
                 completion_model=None):
        self.net = net
        self.name = name
        self.chips = chips
        self.hbm_gb_per_chip = hbm_gb_per_chip
        self.region = region
        self.lake = lake
        self.node = Forwarder(net, name=f"{name}-gateway", strategy=strategy)
        self.endpoints: List[ServiceEndpoint] = []
        self.matchmaker = Matchmaker(memory_model=memory_model,
                                     hbm_gb_per_chip=hbm_gb_per_chip,
                                     max_queue_depth=max_queue_depth)
        self.jobs: Dict[str, Job] = {}
        self.free_chips = chips
        self.alive = True
        # slow-node gray fault (workflow/faults.py FaultInjector.slow_node):
        # real execution stretches by this factor while the scheduler's
        # *predictions* stay optimistic — ETAs only catch up as the
        # completion model observes the dilated run times.  1.0 = healthy.
        self.time_dilation = 1.0
        self.completed_jobs = 0
        self.failed_jobs = 0
        self.scheduler = ClusterScheduler(self, config=scheduler_config,
                                          model=completion_model)
        # what the cluster *advertises* may differ from what it physically
        # has (drain by advertising chips=0, shrink by advertising fewer);
        # the overlay re-originates through on_caps_changed when it moves
        self.advertise_overrides: Dict[str, Any] = {}
        self.on_caps_changed: Optional[Callable[[], None]] = None
        # capability-record cache: the record is consulted on every
        # admission and every routing refresh; rebuild only when the
        # scheduler or the advertised capabilities actually changed
        self._caps_cache: Optional[Dict[str, Any]] = None
        self._caps_key: Tuple[int, int] = (-1, -1)
        # load-triggered re-advertisement damping state: what was last
        # pushed into the gossip, and when
        self._advertised_load: Dict[str, float] = {
            "free_chips": float(chips), "queue_depth": 0.0, "eta_p50": 0.0}
        self._last_readvertise = net.now

    # -- capability view used by validators --------------------------------
    def capabilities(self) -> Dict[str, Any]:
        archs: set = set()
        shapes: set = set()
        apps: set = set()
        serve_families: set = set()
        for e in self.endpoints:
            apps.add(e.app)
            archs.update(e.archs)
            shapes.update(e.shapes)
            if e.app == "serve":
                serve_families.update(e.families)
        return {
            "apps": tuple(sorted(apps)),
            "archs": tuple(sorted(archs)),
            "shapes": tuple(sorted(shapes)),
            "serve_families": tuple(sorted(serve_families)),
            "chips": self.chips,
            "hbm_gb_total": self.chips * self.hbm_gb_per_chip,
            "blast_dbs": ("human", "mouse"),
            "region": self.region,
        }

    def add_endpoint(self, endpoint: ServiceEndpoint) -> None:
        self.endpoints.append(endpoint)
        self._caps_cache = None
        if self.on_caps_changed is not None:
            self.on_caps_changed()

    # -- the advertised capability record (protocol-facing) -----------------
    def capability_record(self) -> Dict[str, Any]:
        """The capability record the routing protocol gossips: the static
        capability view plus live load signals (free chips, admission-queue
        depth, median predicted completion ``eta_p50``), with any operator
        overrides applied.  This — not a static endpoint list held by the
        overlay — is what remote matchmaking and strategies see.

        The dict is cached behind a dirty flag: admission consults it per
        job and the routing layer per refresh, but it only changes when
        the scheduler state or the advertised capabilities move
        (:meth:`_load_changed` invalidates; a cheap live-signal key also
        catches direct ``free_chips`` mutation in tests/benchmarks).
        ``eta_p50`` is therefore "as of the last scheduler event" —
        between events the running jobs' release times are fixed, so the
        staleness is bounded by the event density, and the gossip refresh
        re-samples the record anyway.
        """
        key = (self.free_chips, self.scheduler.queue_depth)
        if self._caps_cache is None or self._caps_key != key:
            record = dict(self.capabilities())
            record["free_chips"] = self.free_chips
            record["queue_depth"] = self.scheduler.queue_depth
            record["eta_p50"] = round(self.scheduler.eta_p50(), 6)
            record.update(self.advertise_overrides)
            self._caps_cache = record
            self._caps_key = key
        return self._caps_cache

    def advertise(self, **overrides: Any) -> None:
        """Override advertised capability fields and re-announce, e.g.
        ``cluster.advertise(chips=0)`` drains the cluster: its compute
        prefixes are withdrawn in-band and — within one advertisement
        lifetime — no new compute Interests arrive."""
        self.advertise_overrides.update(overrides)
        self._caps_cache = None
        if self.on_caps_changed is not None:
            self.on_caps_changed()

    def advertised_prefixes(self) -> List[Name]:
        """Name prefixes this cluster currently offers, derived from its
        capability record: its status namespace, one compute prefix per
        advertised app (refined per arch), and the data namespace if it
        hosts a lake.  A cluster whose advertised chip count is zero
        offers no compute prefixes at all."""
        prefixes = [Name.parse(STATUS_PREFIX).append(self.name)]
        record = self.capability_record()
        if int(record.get("chips", 0)) > 0:
            seen = set()
            for e in self.endpoints:
                generic = Name.parse(COMPUTE_PREFIX).append(e.app)
                if str(generic) not in seen:
                    seen.add(str(generic))
                    prefixes.append(generic)
                # batched submission rides the same capability: any
                # cluster that can run <app> jobs can fan a batch of
                # them out internally (sessions are inherently per-
                # client, so the serve app does not batch)
                if e.app != "serve":
                    batch = Name.parse(BATCH_PREFIX).append(e.app)
                    if str(batch) not in seen:
                        seen.add(str(batch))
                        prefixes.append(batch)
                for arch in e.archs:
                    refined = generic.append(arch)
                    if str(refined) not in seen:
                        seen.add(str(refined))
                        prefixes.append(refined)
                # inference sessions route under the model-rooted serve
                # namespace; announce it per served model so LPM steers a
                # session to any cluster holding the weights
                if e.app == "serve":
                    base = Name.parse(SERVE_PREFIX)
                    if str(base) not in seen:
                        seen.add(str(base))
                        prefixes.append(base)
                    for arch in e.archs:
                        model = base.append(arch)
                        if str(model) not in seen:
                            seen.add(str(model))
                            prefixes.append(model)
        if self.lake is not None:
            prefixes.append(Name.parse(DATA_PREFIX))
        return prefixes

    # -- load signal plumbing ------------------------------------------------
    def _load_changed(self) -> None:
        """Scheduler state moved: invalidate the capability-record cache
        and, when the load swing is significant, re-advertise through the
        routing protocol — damped, so gossip reflects load changes within
        one refresh interval without flooding an advertisement per job.
        """
        self._caps_cache = None
        if self.on_caps_changed is None:
            return
        cfg = self.scheduler.cfg
        now = self.net.now
        if now - self._last_readvertise < cfg.readvertise_min_interval:
            return
        cur = {"free_chips": float(self.free_chips),
               "queue_depth": float(self.scheduler.queue_depth),
               "eta_p50": self.scheduler.eta_p50()}
        if not self._load_swing(self._advertised_load, cur,
                                cfg.readvertise_factor):
            return
        self._advertised_load = cur
        self._last_readvertise = now
        self.on_caps_changed()

    @staticmethod
    def _load_swing(last: Dict[str, float], cur: Dict[str, float],
                    factor: float) -> bool:
        """Did any load signal move enough to be worth a triggered
        re-advertisement?  Saturation flips (free chips or queue crossing
        zero) always count; otherwise a signal must change by at least
        ``factor``x in either direction."""
        for key in ("free_chips", "queue_depth", "eta_p50"):
            a, b = last.get(key, 0.0), cur.get(key, 0.0)
            if (a <= 0.0) != (b <= 0.0):
                return True
            if a > 0.0 and b > 0.0 and max(a / b, b / a) >= factor:
                return True
        return False

    # -- job lifecycle -------------------------------------------------------
    def submit(self, spec: JobSpec, now: float) -> Job:
        """Bind, admit and schedule a job. Raises MatchError if infeasible.

        When the matchmaker allows queued admission, a job whose grant
        exceeds the currently free chips is parked Pending on the
        scheduler's queue and started — in effective-priority order, with
        backfill and aging — as chips free up.

        Admission is bounded by the *advertised* capability record, not
        raw hardware: a cluster that advertised itself down to N chips
        honors N even if it physically has more — the advertisement is a
        contract with the network that routed the Interest here.
        """
        scheduler = self.scheduler
        endpoint, grant = self.matchmaker.match(
            spec, self.endpoints, self.free_chips,
            queue_depth=scheduler.queue_depth,
            total_chips=self.chips,
            advertised=self.capability_record(),
            eta_fn=lambda e, g: scheduler.run_estimate(spec)
                                * (1.0 + e.running))
        job = Job(spec=spec, cluster=self.name, submitted_at=now,
                  granted_chips=grant, endpoint=endpoint.service)
        self.jobs[job.job_id] = job
        scheduler.admit(job, endpoint, grant)
        return job

    def submit_batch(self, specs: List[JobSpec], now: float,
                     on_admitted: Optional[Callable[[List[Job]], None]] = None
                     ) -> List[Job]:
        """Admit a *homogeneous* batch: one matchmaking decision and one
        run estimate for the template, O(1) bookkeeping per member.

        ``on_admitted(jobs)`` — when given — runs after the members are
        registered in :attr:`jobs` but *before* the scheduler dispatches
        them, so callers (the gateway's batch bookkeeping) observe every
        completion hook, including members that finish synchronously
        during dispatch."""
        if not specs:
            return []
        scheduler = self.scheduler
        template = specs[0]
        endpoint, grant = self.matchmaker.match(
            template, self.endpoints, self.free_chips,
            queue_depth=scheduler.queue_depth,
            total_chips=self.chips,
            advertised=self.capability_record(),
            eta_fn=lambda e, g: scheduler.run_estimate(template)
                                * (1.0 + e.running))
        est = scheduler.run_estimate(template)
        jobs = []
        for spec in specs:
            job = Job(spec=spec, cluster=self.name, submitted_at=now,
                      granted_chips=grant, endpoint=endpoint.service)
            self.jobs[job.job_id] = job
            jobs.append(job)
        if on_admitted is not None:
            on_admitted(jobs)
        scheduler.admit_batch(jobs, endpoint, grant, est)
        return jobs

    # -- failure injection ----------------------------------------------------
    def fail(self) -> None:
        """The whole cluster goes dark (power/network loss)."""
        self.alive = False
        self._caps_cache = None
        for f in self.node.faces.values():
            f.down = True

    def restore(self) -> None:
        self.alive = True
        self._caps_cache = None
        for f in self.node.faces.values():
            f.down = False

    # -- utilization ----------------------------------------------------------
    @property
    def utilization(self) -> float:
        return 1.0 - self.free_chips / max(self.chips, 1)
