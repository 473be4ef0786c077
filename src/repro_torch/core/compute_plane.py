"""The compute plane: a real cluster scheduler behind every gateway.

This module absorbs the job lifecycle that used to be spread across
``ComputeCluster`` (`_waitq`/`_start`/`_drain_waitq`) and grows it into a
scheduler the paper's §VII future work asks for — "identify the most
suitable cluster for executing requests ... leveraging machine learning
algorithms to predict completion times":

* **Priority classes** — jobs carry a ``prio=`` field (higher = more
  urgent); dispatch order is *effective* priority: base priority plus an
  aging boost per waited second, so a steady stream of urgent work can
  never starve batch jobs forever.
* **Preemption at phase boundaries** — a blocked higher-priority job may
  preempt running lower-priority :class:`~repro_torch.core.cluster.ExecPlan`
  jobs: the victim releases its chips at its *next phase boundary*
  (completed phases' checkpoints are already in the lake) and is
  re-queued with its remaining phases retained, so a local resume
  re-executes nothing.  If the job instead lands on another cluster (the
  client re-expressed its canonical name), the executor resumes from the
  lake checkpoints the completed phases published — same guarantee,
  decentralized.
* **Backfill that never starves** — while the head-of-line job waits for
  chips, smaller jobs may start around it, but only until the head's
  wait exceeds ``starvation_age``; past that the freed chips are
  *reserved* and accumulate until the head fits.
* **ETA-aware admission** — the scheduler keeps exact expected release
  times for running jobs (phase durations are known on the virtual
  clock) and an online :class:`~repro_torch.core.scheduler.CompletionModel`
  over locally observed run times; :meth:`eta` greedily simulates the
  chip timeline to predict when a new job would complete.  That ETA is
  what the gateway puts in receipts and busy answers, what
  ``capability_record()`` gossips as ``eta_p50``, and what
  :meth:`should_spill` compares against the spill threshold.

The scheduler is deliberately *cluster-local*: cross-cluster placement
stays in the network (strategies ranking busy-receipt ETAs, gateways
re-expressing Interests upstream) — no controller appears here.

The port's copy of ``repro/core/compute_plane.py``: the same logic, its imports
pointing inside ``repro_torch``.
"""

from __future__ import annotations

import heapq
import itertools
import statistics
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from .jobs import Job, JobSpec, result_name_for
from .scheduler import CompletionModel

__all__ = ["SchedulerConfig", "ClusterScheduler", "LOCAL_FACE"]

# CompletionModel face id for the cluster's own observations (run times
# measured at the executor, not through any network face).
LOCAL_FACE = -1


@dataclass
class SchedulerConfig:
    """Policy knobs for one cluster's scheduler.

    The defaults reproduce the historical admit→FIFO-queue→execute
    behaviour for workloads that carry no priorities (equal priorities
    never preempt; backfill within ``starvation_age`` is what the old
    greedy wait-queue drain did); the property tests in
    ``tests/test_compute_plane.py`` hold the equivalence.
    """

    preemption: bool = True          # priorities may preempt at boundaries
    aging_rate: float = 0.05         # effective-priority points per waited s
    starvation_age: float = 10.0     # head waiting longer blocks backfill
    default_run_estimate: float = 1.0  # ETA prior for never-seen work
    # structural run-time predictor consulted *before* the learned
    # CompletionModel: apps whose duration is computable from the job
    # fields alone (a serving session's prefill + max_new decode steps)
    # plug one in, so ETAs are exact from the very first request instead
    # of converging after observations.  Return None to fall through.
    run_estimator: Optional[Callable[[JobSpec], Optional[float]]] = None
    # -- decentralized spill (work shedding via the gateway) ----------------
    spill_queue_depth: Optional[int] = None   # queue deeper than this spills
    spill_eta: Optional[float] = None         # predicted wait above this spills
    max_spill_hops: int = 2          # bound on the hop-carried spill= path
    spill_lifetime: float = 4.0      # lifetime of the re-expressed Interest
    # -- load-triggered re-advertisement damping (used by ComputeCluster) ---
    readvertise_factor: float = 2.0      # re-advertise on >= this load swing
    readvertise_min_interval: float = 0.5  # but never more often than this
    # -- brownout: graceful degradation under sustained overload ------------
    # When the admission queue reaches brownout_queue_depth, the gateway
    # stops admitting the *lowest* waiting priority classes (one more class
    # per additional multiple of the depth) and answers them with busy
    # receipts whose quoted ETA grows with the overload level — callers
    # back off proportionally instead of every class timing out equally.
    brownout_queue_depth: Optional[int] = None
    brownout_eta_growth: float = 0.5     # ETA stretch per overload level

    @property
    def brownout_enabled(self) -> bool:
        return self.brownout_queue_depth is not None

    @property
    def spill_enabled(self) -> bool:
        return (self.spill_queue_depth is not None
                or self.spill_eta is not None)


@dataclass
class _Queued:
    """A job admitted but not (currently) running.

    ``plan``/``phase`` are set when this entry is a *preempted* job: the
    remaining execution plan is retained so a local resume skips every
    completed phase (their side effects — checkpoints in the lake —
    already happened)."""

    job: Job
    endpoint: Any                    # matchmaker.ServiceEndpoint
    grant: int
    priority: int
    enqueued_at: float
    seq: int
    run_estimate: float
    plan: Optional[Any] = None       # cluster.ExecPlan (remaining phases)
    phase: int = 0                   # next phase index on resume
    consumed: float = 0.0            # on-chip seconds before preemption(s)

    def effective_priority(self, now: float, aging_rate: float) -> float:
        return self.priority + aging_rate * max(0.0, now - self.enqueued_at)


@dataclass
class _Running:
    job: Job
    endpoint: Any
    grant: int
    priority: int
    expected_release: float          # absolute virtual-time estimate
    plan: Optional[Any] = None       # ExecPlan, if phased
    phase: int = 0                   # phase currently executing
    preempt: bool = False            # release chips at next phase boundary
    consumed: float = 0.0            # on-chip seconds from earlier segments


class ClusterScheduler:
    """One cluster's admit→queue→execute→complete engine."""

    def __init__(self, cluster, config: Optional[SchedulerConfig] = None,
                 model: Optional[CompletionModel] = None):
        self.cluster = cluster
        self.net = cluster.net
        self.cfg = config or SchedulerConfig()
        self.model = model or CompletionModel()
        self._queue: List[_Queued] = []
        self._running: Dict[str, _Running] = {}
        self._seq = itertools.count(1)
        # dispatch reentrancy: a synchronously failing executor finishes
        # inside _start and recursively re-dispatches; the guard folds
        # that into the outer loop so the outer pass never works from a
        # stale snapshot of the queue
        self._dispatching = False
        self._redispatch = False
        # observers: gateway evicts its dedupe map, benchmarks count, ...
        self.on_job_done: List[Callable[[Job], None]] = []
        self.stats = {"started": 0, "completed": 0, "failed": 0,
                      "preemptions": 0, "resumes": 0, "backfills": 0}

    # ------------------------------------------------------------- queries
    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def running_count(self) -> int:
        return len(self._running)

    def queued_jobs(self) -> List[Job]:
        return [q.job for q in self._ordered(self.net.now)]

    def run_estimate(self, spec: JobSpec) -> float:
        """Predicted run time for this work on this cluster: the online
        completion model's estimate if it has one (exact job key first,
        then the cross-job regression), else a configured prior.  The
        prediction is per-spec — the requested chips are part of the job
        key, and observations are made under the grants those requests
        actually received."""
        if self.cfg.run_estimator is not None:
            est = self.cfg.run_estimator(spec)
            if est is not None and est > 0:
                return float(est)
        pred = self.model.predict({"app": spec.app, **spec.fields},
                                  face_id=LOCAL_FACE)
        if pred is not None and pred > 0:
            return float(pred)
        return self.cfg.default_run_estimate

    # ---------------------------------------------------------------- eta
    def _ordered(self, now: float) -> List[_Queued]:
        return sorted(self._queue,
                      key=lambda q: (-q.effective_priority(
                          now, self.cfg.aging_rate), q.seq))

    def _simulate(self, extra: Optional[Tuple[int, int, float]] = None
                  ) -> Tuple[Dict[str, float], Optional[float]]:
        """Greedily replay the chip timeline: running jobs release at
        their expected times, queued jobs start head-first in dispatch
        order.  Returns ({job_id: eta_seconds}, eta of the hypothetical
        ``extra`` = (priority, grant, run_estimate) arrival, if given).
        """
        now = self.net.now
        free = self.cluster.free_chips
        releases = [(rec.expected_release, rec.grant)
                    for rec in self._running.values()]
        heapq.heapify(releases)
        order: List[Tuple[float, int, int, float, Optional[str]]] = [
            (-q.effective_priority(now, self.cfg.aging_rate), q.seq,
             q.grant, q.run_estimate, q.job.job_id)
            for q in self._queue]
        extra_eta: Optional[float] = None
        if extra is not None:
            prio, grant, est = extra
            order.append((-float(prio), next(self._seq), grant, est, None))
        order.sort(key=lambda t: (t[0], t[1]))
        t = now
        etas: Dict[str, float] = {}
        for _, _, grant, est, job_id in order:
            while free < grant and releases:
                rt, g = heapq.heappop(releases)
                t = max(t, rt)
                free += g
            if free < grant:
                # cannot be satisfied from the modeled timeline (e.g. a
                # queued-admission grant above what is currently running)
                t = t + est
            start = t
            free -= grant
            heapq.heappush(releases, (start + est, grant))
            if job_id is None:
                extra_eta = (start + est) - now
            else:
                etas[job_id] = (start + est) - now
        return etas, extra_eta

    def eta(self, spec: JobSpec, grant: Optional[int] = None,
            run_estimate: Optional[float] = None) -> float:
        """Predicted seconds until a *newly admitted* job completes."""
        grant = grant if grant is not None else spec.chips(default=1)
        est = (run_estimate if run_estimate is not None
               else self.run_estimate(spec))
        _, extra = self._simulate(extra=(spec.priority, grant, est))
        assert extra is not None
        return extra

    def eta_of(self, job_id: str) -> Optional[float]:
        """Predicted seconds until an admitted job completes (running:
        exact expected release; queued: simulated start + run)."""
        rec = self._running.get(job_id)
        if rec is not None:
            return max(0.0, rec.expected_release - self.net.now)
        etas, _ = self._simulate()
        return etas.get(job_id)

    def queued_etas(self) -> Dict[str, float]:
        """One chip-timeline replay for *all* queued jobs — callers
        answering a multi-job status poll pay the O(queue log queue)
        simulation once instead of once per job."""
        etas, _ = self._simulate()
        return etas

    def running_started(self) -> Dict[str, float]:
        """start time of every on-chip job — the straggler signal batch
        status answers carry (a task's on-chip age, not its queue age,
        is what speculation should trigger on)."""
        now = self.net.now
        return {jid: (rec.job.started_at
                      if rec.job.started_at is not None else now)
                for jid, rec in self._running.items()}

    def eta_p50(self) -> float:
        """Median predicted completion over currently queued jobs — the
        load signal ``capability_record()`` gossips.  0 when nothing
        queues (an idle or merely-busy cluster completes new work at its
        run estimate, which the FIB cost already reflects via free
        chips)."""
        if not self._queue:
            return 0.0
        etas, _ = self._simulate()
        queued = [etas[q.job.job_id] for q in self._queue
                  if q.job.job_id in etas]
        return float(statistics.median(queued)) if queued else 0.0

    # ----------------------------------------------------------- brownout
    def brownout_level(self) -> int:
        """Overload depth in units of the brownout threshold (0 = none)."""
        cfg = self.cfg
        if not cfg.brownout_enabled or cfg.brownout_queue_depth <= 0:
            return 0
        return self.queue_depth // cfg.brownout_queue_depth

    def brownout_sheds(self, priority: int) -> bool:
        """Would an arrival of this priority class be shed right now?

        Under level-L brownout the L lowest priority classes (among what
        is queued plus the arrival itself) are refused with busy receipts;
        higher classes keep being admitted — load-shedding by class, not
        uniform timeout."""
        level = self.brownout_level()
        if level <= 0:
            return False
        classes = sorted({q.priority for q in self._queue} | {priority})
        return priority in classes[:level]

    # -------------------------------------------------------------- spill
    def should_spill(self, spec: JobSpec, want: int) -> bool:
        """Past the spill threshold? (Feasible-but-saturated only: work
        nothing here could ever run is the matchmaker's Nack, not a
        spill.)  ``want`` is capped at what the serving endpoints could
        actually grant — a job the matchmaker would down-size onto free
        chips must start here, not travel."""
        cfg = self.cfg
        if not cfg.spill_enabled:
            return False
        serving = [e for e in self.cluster.endpoints if e.serves(spec)]
        if not serving:
            return False
        grants = [min(want, e.max_chips) for e in serving
                  if min(want, e.max_chips) >= e.min_chips]
        if not grants:
            return False        # structurally ungrantable: matchmaker's call
        grant = min(grants)     # the smallest grant any endpoint would make
        if grant <= self.cluster.free_chips:
            return False        # would start now (possibly down-sized)
        if (cfg.spill_queue_depth is not None
                and self.queue_depth >= cfg.spill_queue_depth):
            return True
        if (cfg.spill_eta is not None
                and self.eta(spec, grant) > cfg.spill_eta):
            return True
        return False

    # ---------------------------------------------------------- admission
    def admit(self, job: Job, endpoint, grant: int) -> None:
        """Take ownership of a matched job: start it now if it fits, else
        queue it (the matchmaker already decided queued admission is
        allowed when ``grant`` exceeds the free chips)."""
        q = _Queued(job=job, endpoint=endpoint, grant=grant,
                    priority=job.spec.priority,
                    enqueued_at=self.net.now, seq=next(self._seq),
                    run_estimate=self.run_estimate(job.spec))
        self._queue.append(q)
        self._dispatch()

    def admit_batch(self, jobs: List[Job], endpoint, grant: int,
                    run_estimate: float) -> None:
        """Admit homogeneous batch members in one call: the run estimate
        and grant were computed once for the template, so admission is
        O(1) bookkeeping per member plus ONE dispatch pass — not a
        per-job completion-model predict and queue re-sort."""
        now = self.net.now
        for job in jobs:
            self._queue.append(_Queued(job=job, endpoint=endpoint,
                                       grant=grant,
                                       priority=job.spec.priority,
                                       enqueued_at=now,
                                       seq=next(self._seq),
                                       run_estimate=run_estimate))
        self._dispatch()

    # ----------------------------------------------------------- dispatch
    def _dispatch(self) -> None:
        if not self.cluster.alive:
            return
        if self._dispatching:
            # a synchronous finish inside _start re-entered us: flag the
            # outer pass to re-sort instead of nesting
            self._redispatch = True
            return
        self._dispatching = True
        try:
            while True:
                self._redispatch = False
                self._dispatch_pass()
                if not self._redispatch:
                    break
        finally:
            self._dispatching = False
        self._reconcile_preempt_marks()
        self.cluster._load_changed()

    def _dispatch_pass(self) -> None:
        """One pass over the priority order, sorted ONCE: virtual time
        cannot advance within a pass, so effective priorities (and hence
        the sort) are invariant until something starts or finishes — a
        10k-member batch admission dispatches in O(n log n), not the
        O(n² log n) of re-sorting per started job."""
        now = self.net.now
        order = self._ordered(now)
        progress = True
        while progress and order:
            if self._redispatch:
                return      # sync finish mutated the queue: re-sort
            progress = False
            head = order[0]
            if head.grant <= self.cluster.free_chips:
                order.pop(0)
                self._queue.remove(head)
                self._start(head)
                progress = True
                continue
            # the head is blocked on chips
            if self.cfg.preemption:
                self._request_preemption(head)
            if now - head.enqueued_at <= self.cfg.starvation_age:
                # backfill around the head — but only while it is young;
                # an aged head reserves every freed chip until it fits
                for i in range(1, len(order)):
                    q = order[i]
                    if q.grant <= self.cluster.free_chips:
                        order.pop(i)
                        self._queue.remove(q)
                        self._start(q)
                        self.stats["backfills"] += 1
                        progress = True
                        break

    def _reconcile_preempt_marks(self) -> None:
        """Unmark victims whose chips are no longer needed — the blocked
        head may have started off naturally freed chips (or the queue
        drained) between the mark and the victim's next phase boundary;
        without this the victim would release for nobody."""
        marked = [rec for rec in self._running.values() if rec.preempt]
        if not marked:
            return
        head = self._ordered(self.net.now)[0] if self._queue else None
        need = (head.grant - self.cluster.free_chips
                if head is not None and self.cfg.preemption else 0)
        for rec in sorted(marked, key=lambda r: (r.priority,
                                                 r.expected_release,
                                                 r.job.job_id)):
            if need > 0 and head is not None and rec.priority < head.priority:
                need -= rec.grant       # still a wanted victim
            else:
                rec.preempt = False

    def _request_preemption(self, head: _Queued) -> None:
        """Mark enough running lower-priority phased jobs to free the
        head's grant; each victim releases at its next phase boundary."""
        need = head.grant - self.cluster.free_chips
        for rec in self._running.values():
            if rec.preempt:
                need -= rec.grant
        if need <= 0:
            return
        victims = sorted(
            (rec for rec in self._running.values()
             if not rec.preempt and rec.plan is not None
             and rec.priority < head.priority            # strict class order
             and rec.phase < len(rec.plan.phases) - 1),  # has phases left
            key=lambda r: (r.priority, r.expected_release, r.job.job_id))
        for rec in victims:
            if need <= 0:
                break
            rec.preempt = True
            need -= rec.grant

    # ------------------------------------------------------------ execute
    def _start(self, q: _Queued) -> None:
        from .cluster import ExecPlan  # local import: cluster imports us
        cluster = self.cluster
        assert q.grant <= cluster.free_chips
        cluster.free_chips -= q.grant
        q.endpoint.running += 1
        q.job.start(self.net.now)
        self.stats["started"] += 1
        rec = _Running(job=q.job, endpoint=q.endpoint, grant=q.grant,
                       priority=q.priority,
                       expected_release=self.net.now + q.run_estimate,
                       consumed=q.consumed)
        self._running[q.job.job_id] = rec
        if q.plan is not None:
            # resuming a preempted job: its remaining plan was retained,
            # completed phases are not re-executed
            self.stats["resumes"] += 1
            rec.plan, rec.phase = q.plan, q.phase
            self._run_phase(rec)
            return
        try:
            assert q.endpoint.executor is not None, \
                f"{q.endpoint.service} has no executor"
            res = q.endpoint.executor(q.job, cluster)
        except Exception as e:  # execution failed synchronously
            self._finish(rec, error=f"{type(e).__name__}: {e}")
            return
        if isinstance(res, ExecPlan):
            rec.plan = res
            self._run_phase(rec)
            return
        # completion lands after the job's *virtual* duration.  A slow
        # node (time_dilation > 1) takes longer than it *predicts* —
        # expected_release stays optimistic, which is the gray-failure
        # signature; the completion model observes the real duration in
        # _finish and drags future ETAs toward the truth.
        rec.expected_release = self.net.now + res.duration
        self.net.schedule(res.duration * cluster.time_dilation,
                          lambda: self._finish(rec, res=res))

    def _run_phase(self, rec: _Running) -> None:
        plan = rec.plan
        if rec.phase >= len(plan.phases):
            try:
                res = plan.finalize()
            except Exception as e:
                self._finish(rec, error=f"{type(e).__name__}: {e}")
                return
            self._finish(rec, res=res)
            return
        duration, work = plan.phases[rec.phase]
        rec.expected_release = self.net.now + sum(
            d for d, _ in plan.phases[rec.phase:])

        def complete_phase() -> None:
            if not self.cluster.alive:
                return  # died mid-phase: this phase's work never happened
            try:
                work()
            except Exception as e:
                self._finish(rec, error=f"{type(e).__name__}: {e}")
                return
            rec.phase += 1
            if rec.preempt and rec.phase < len(plan.phases):
                # the phase boundary is the preemption point: chips go to
                # the higher-priority job, this one re-queues with its
                # remaining phases (checkpoints of completed phases are
                # already in the lake)
                self._release_preempted(rec)
                return
            self._run_phase(rec)

        # slow-node dilation stretches the real phase, not the prediction
        self.net.schedule(duration * self.cluster.time_dilation,
                          complete_phase)

    def _release_preempted(self, rec: _Running) -> None:
        self._running.pop(rec.job.job_id, None)
        self.cluster.free_chips += rec.grant
        rec.endpoint.running -= 1
        rec.job.preempt(self.net.now)
        # counted here — at the boundary where chips actually moved — so
        # the stat means real preemptions, not reconciled-away requests
        self.stats["preemptions"] += 1
        remaining = sum(d for d, _ in rec.plan.phases[rec.phase:])
        started = rec.job.started_at if rec.job.started_at is not None \
            else self.net.now
        self._queue.append(_Queued(
            job=rec.job, endpoint=rec.endpoint, grant=rec.grant,
            priority=rec.priority, enqueued_at=self.net.now,
            seq=next(self._seq), run_estimate=remaining,
            plan=rec.plan, phase=rec.phase,
            consumed=rec.consumed + (self.net.now - started)))
        self._dispatch()

    # ------------------------------------------------------------- finish
    def _finish(self, rec: _Running,
                res=None, error: Optional[str] = None) -> None:
        cluster = self.cluster
        self._running.pop(rec.job.job_id, None)
        cluster.free_chips += rec.grant
        rec.endpoint.running -= 1
        if not cluster.alive:
            return  # cluster died mid-job: job stays Running forever
                    # (clients time out, retransmit, land elsewhere)
        now = self.net.now
        job = rec.job
        if error is not None or res is None:
            job.fail(now, error or "executor returned nothing")
            self.stats["failed"] += 1
            cluster.failed_jobs += 1
        else:
            job.complete(now, res.payload)
            self.stats["completed"] += 1
            cluster.completed_jobs += 1
            if job.started_at is not None:
                # total on-chip time across preemption segments — the
                # final segment alone would teach the model too-short
                # durations for preempted work
                duration = rec.consumed + (now - job.started_at)
                self.model.observe({"app": job.spec.app, **job.spec.fields},
                                   face_id=LOCAL_FACE,
                                   duration=max(duration, 1e-9))
            if cluster.lake is not None:
                rname = result_name_for(job.spec)
                cluster.lake.put_json(rname, {"job_id": job.job_id,
                                              "cluster": cluster.name,
                                              **res.payload})
                if res.arrays:
                    cluster.lake.put_arrays(rname.append("arrays"),
                                            res.arrays)
        for cb in self.on_job_done:
            cb(job)
        self._dispatch()
