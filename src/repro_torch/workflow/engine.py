"""The workflow engine: drive a compiled DAG through the forwarding plane.

The engine is a *client* — it holds no scheduling authority.  Every stage
is submitted as an ordinary compute Interest through the forwarder, so
placement stays location-independent: the strategy layer picks the
cluster, identical stages hit the Content-Store / result cache, and a
crashed cluster is routed around by the same retransmission machinery
that serves single jobs.

Execution is event-driven on the deterministic virtual clock: stages
launch the moment their dependencies complete (scatter instances run
concurrently), status is polled per stage, and a stage whose cluster goes
dark mid-run is re-expressed — the canonical name lands on a surviving
cluster, which re-executes *that stage only*; completed upstream results
are already in the lake under their own names.

Everything observable is appended to ``run.trace`` as
``(virtual_time, event, stage_instance, detail)`` tuples; with a fixed
fault seed two runs produce byte-identical traces, which is what the
fault-injection tests assert.

The port's copy of ``repro/workflow/engine.py``: the same logic, its imports
pointing inside ``repro_torch``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..core import reasons
from ..core.forwarder import Consumer, Forwarder, Network
from ..core.names import STATUS_PREFIX, Name
from ..core.packets import Data, Interest, verify_trusted
from ..core.resilience import ENGINE_BUSY, ENGINE_NOROUTE, RetryPolicy
from ..datalake.fetch import SegmentFetcher
from .dag import StageInstance, Workflow

__all__ = ["StageStatus", "WorkflowRun", "WorkflowEngine"]


class StageStatus:
    WAITING = "waiting"        # dependencies not complete
    SUBMITTED = "submitted"    # compute Interest in flight
    RUNNING = "running"        # receipt received, polling status
    COMPLETE = "complete"
    FAILED = "failed"          # out of attempts


@dataclass
class _StageRun:
    inst: StageInstance
    status: str = StageStatus.WAITING
    attempts: int = 0
    waiting_on: int = 0                       # unfinished deps
    receipt: Optional[Dict[str, Any]] = None
    cluster: Optional[str] = None
    from_cache: bool = False                  # completed straight off receipt
    submitted_at: Optional[float] = None
    completed_at: Optional[float] = None
    noroute_retries: int = 0                  # free retries while routes gossip
    busy_retries: int = 0                     # free backoff retries on busy


@dataclass
class WorkflowRun:
    workflow: Workflow
    stages: Dict[str, _StageRun]
    started_at: float = 0.0
    finished_at: Optional[float] = None
    failed: Optional[str] = None              # first failed stage id
    results: Dict[str, Any] = field(default_factory=dict)  # sink payloads
    trace: List[Tuple[float, str, str, str]] = field(default_factory=list)
    # completion bookkeeping, filled by the engine at start()
    remaining: int = 0                        # stages not yet complete
    dependents: Dict[str, List[str]] = field(default_factory=dict)

    @property
    def complete(self) -> bool:
        return (self.failed is None
                and all(s.status == StageStatus.COMPLETE
                        for s in self.stages.values()))

    @property
    def makespan(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.started_at

    @property
    def cache_hits(self) -> int:
        return sum(1 for s in self.stages.values() if s.from_cache)

    @property
    def resubmissions(self) -> int:
        return sum(max(0, s.attempts - 1) for s in self.stages.values())

    def stage_report(self) -> Dict[str, Dict[str, Any]]:
        return {i: {"status": s.status, "attempts": s.attempts,
                    "cluster": s.cluster, "from_cache": s.from_cache}
                for i, s in self.stages.items()}


class WorkflowEngine:
    """Submit→poll→fetch per stage, DAG-ordered, over one Consumer."""

    def __init__(self, net: Network, node: Forwarder, *,
                 name: str = "wf-engine",
                 poll_interval: float = 0.25,
                 interest_lifetime: float = 4.0,
                 express_retries: int = 3,
                 max_stage_attempts: int = 4,
                 fetch_sink_results: bool = True,
                 completion_model=None,
                 noroute_policy: RetryPolicy = ENGINE_NOROUTE,
                 busy_policy: RetryPolicy = ENGINE_BUSY):
        self.net = net
        self.consumer = Consumer(net, node, name=name)
        self.poll_interval = poll_interval
        self.interest_lifetime = interest_lifetime
        self.express_retries = express_retries
        self.max_stage_attempts = max_stage_attempts
        self.fetch_sink_results = fetch_sink_results
        # named retry schedules (core/resilience.py): free no-route
        # retries while routes gossip, and busy backoff whose delays are
        # in units of the poll interval — the defaults reproduce the old
        # hard-coded 3 / 4-with-linear-backoff behavior exactly
        self.noroute_policy = noroute_policy
        self.busy_policy = busy_policy
        self._busy_delays = busy_policy.scaled(poll_interval)
        # optional repro_torch.core.scheduler.CompletionModel: observed stage
        # durations feed the paper's §VII completion-time intelligence
        self.completion_model = completion_model
        # poll coalescing: stages pending at the same gateway share one
        # timer and one ids= multi-status Interest per cadence instead of
        # polling independently — a fanout-N scatter costs O(1) status
        # traffic per cluster per interval, not O(N)
        self._poll_groups: Dict[str, Dict[str, Tuple[WorkflowRun, _StageRun,
                                                     int]]] = {}
        self.stage_polls = 0         # per-stage poll requests
        self.status_interests = 0    # status Interests actually expressed

    # ------------------------------------------------------------------ api
    def run(self, workflow: Workflow) -> WorkflowRun:
        """Start the workflow and drive the network to quiescence."""
        run = self.start(workflow)
        self.net.run()
        return run

    def start(self, workflow: Workflow) -> WorkflowRun:
        """Launch root stages; callers must drive ``net`` themselves."""
        stages = {i: _StageRun(inst=inst, waiting_on=len(inst.deps))
                  for i, inst in workflow.instances.items()}
        run = WorkflowRun(workflow=workflow, stages=stages,
                          started_at=self.net.now,
                          remaining=len(stages),
                          dependents=workflow.dependents())
        self._trace(run, "workflow-start", workflow.name,
                    f"stages={len(stages)}")
        for sr in stages.values():
            if sr.waiting_on == 0:
                self._launch(run, sr)
        return run

    # ------------------------------------------------------------ plumbing
    def _trace(self, run: WorkflowRun, event: str, who: str, detail: str = ""
               ) -> None:
        run.trace.append((round(self.net.now, 9), event, who, detail))

    def _launch(self, run: WorkflowRun, sr: _StageRun) -> None:
        if run.failed is not None:
            return
        sr.attempts += 1
        sr.status = StageStatus.SUBMITTED
        if sr.submitted_at is None:
            sr.submitted_at = self.net.now
        self._trace(run, "submit", sr.inst.id, f"attempt={sr.attempts}")
        self.consumer.express(
            Interest(name=sr.inst.request_name,
                     lifetime=self.interest_lifetime, must_be_fresh=True),
            on_data=lambda d, sr=sr: self._on_receipt(run, sr, d),
            on_fail=lambda reason, sr=sr: self._on_submit_fail(run, sr, reason),
            retries=self.express_retries)

    def _on_receipt(self, run: WorkflowRun, sr: _StageRun, d: Data) -> None:
        if sr.status not in (StageStatus.SUBMITTED,):
            return  # late duplicate (e.g. multicast twin) — already handled
        if verify_trusted(d) is False:
            # corrupted receipt (wire byte-flip caught by the HMAC): the
            # pending state is already consumed, so silently ignoring
            # would hang the stage — treat it as a failed submit attempt
            return self._on_submit_fail(run, sr, "corrupt-receipt")
        try:
            receipt = d.json()
        except (ValueError, UnicodeDecodeError):
            return self._on_submit_fail(run, sr, "corrupt-receipt")
        sr.receipt = receipt
        sr.cluster = receipt.get("cluster")
        self._trace(run, "receipt", sr.inst.id,
                    f"state={receipt.get('state')} cluster={sr.cluster}")
        if receipt.get("state") == "Completed":
            # served from the result cache (or a twin workflow finished it):
            # no new execution happened for this run's benefit
            sr.from_cache = True
            self._complete(run, sr)
            return
        sr.status = StageStatus.RUNNING
        self._schedule_poll(run, sr, delay=self.poll_interval)

    def _on_submit_fail(self, run: WorkflowRun, sr: _StageRun, reason: str
                        ) -> None:
        if sr.status != StageStatus.SUBMITTED:
            return
        self._trace(run, "submit-fail", sr.inst.id, reason)
        if (reasons.is_no_route_failure(reason)
                and self.noroute_policy.allows(sr.noroute_retries + 1)):
            # the overlay hasn't converged on this prefix yet (clusters
            # join by advertising — zero pre-configuration means a stage
            # can race the gossip): re-express without burning one of the
            # crash-recovery attempts.  Only the *submit* path gets this;
            # a status loss mid-run is a real recovery attempt.
            sr.noroute_retries += 1
            sr.attempts -= 1
        elif (reasons.is_busy_failure(reason)
                and self.busy_policy.allows(sr.busy_retries + 1)):
            # every reachable cluster quoted a busy receipt: the fleet is
            # saturated, not broken.  Back off on the busy schedule and
            # re-express without burning a crash-recovery attempt — the
            # re-expressed Interest re-ranks by the quoted ETAs (and by
            # then some cluster's queue has drained or spilled).
            sr.busy_retries += 1
            sr.attempts -= 1
            self._retry_or_fail(run, sr, f"submit:{reason}",
                                delay=self._busy_delays.delay(sr.busy_retries))
            return
        self._retry_or_fail(run, sr, f"submit:{reason}")

    def _retry_or_fail(self, run: WorkflowRun, sr: _StageRun, reason: str,
                       delay: float = 0.0) -> None:
        if sr.attempts < self.max_stage_attempts:
            if delay > 0.0:
                attempt = sr.attempts

                def relaunch() -> None:
                    # still waiting on this very attempt? (a late duplicate
                    # receipt may have completed the stage meanwhile)
                    if (sr.status == StageStatus.SUBMITTED
                            and sr.attempts == attempt):
                        self._launch(run, sr)

                self.net.schedule(delay, relaunch)
            else:
                self._launch(run, sr)
            return
        sr.status = StageStatus.FAILED
        if run.failed is None:
            run.failed = sr.inst.id
            run.finished_at = self.net.now
        self._trace(run, "stage-failed", sr.inst.id, reason)

    # ------------------------------------------------------------- status
    # how many stages one ids= multi-status Interest may cover (stays
    # comfortably inside the gateway's MAX_STATUS_IDS answer bound)
    POLL_CHUNK = 32

    def _schedule_poll(self, run: WorkflowRun, sr: _StageRun, delay: float
                      ) -> None:
        """Arm the next status poll for a running stage.

        Stages pending at the same gateway coalesce: the first request
        arms one timer for that cluster; stages joining before it fires
        ride along, and the firing sends one ids= multi-status Interest
        for the whole group.  (A joiner keeps the incumbent cadence — at
        worst it is polled one interval early, and the answer's 0.25 s
        freshness makes the extra sample cheap.)"""
        self.stage_polls += 1
        attempt = sr.attempts
        if sr.cluster is None:
            # no receipt-confirmed gateway to group under: poll solo
            self.net.schedule(delay, lambda: self._poll(run, sr, attempt))
            return
        cluster = sr.cluster
        group = self._poll_groups.get(cluster)
        if group is None:
            self._poll_groups[cluster] = {sr.inst.id: (run, sr, attempt)}
            self.net.schedule(delay, lambda: self._poll_cluster(cluster))
        else:
            group[sr.inst.id] = (run, sr, attempt)

    def _poll_live(self, entry: Tuple[WorkflowRun, _StageRun, int]) -> bool:
        run, sr, attempt = entry
        return (sr.status == StageStatus.RUNNING and sr.attempts == attempt
                and run.failed is None)

    def _poll_cluster(self, cluster: str) -> None:
        """One cadence firing for every stage pending at ``cluster``."""
        group = self._poll_groups.pop(cluster, None)
        if not group:
            return
        live = [e for e in group.values() if self._poll_live(e)]
        if not live:
            return
        if len(live) == 1:
            run, sr, attempt = live[0]
            self._poll(run, sr, attempt)
            return
        for i in range(0, len(live), self.POLL_CHUNK):
            chunk = live[i:i + self.POLL_CHUNK]
            # deduped twin stages share one gateway job — key by job_id,
            # fan the one answer out to every stage waiting on it
            by_jid: Dict[str, List[Tuple[WorkflowRun, _StageRun, int]]] = {}
            for e in chunk:
                by_jid.setdefault(e[1].receipt["job_id"], []).append(e)
            name = Name.parse(STATUS_PREFIX).append(
                cluster, "ids=" + ",".join(sorted(by_jid)))
            self.status_interests += 1
            self.consumer.express(
                Interest(name=name, must_be_fresh=True, lifetime=2.0),
                on_data=lambda d, by_jid=by_jid: self._on_multi_status(
                    by_jid, d),
                on_fail=lambda r, by_jid=by_jid: self._fan_status_fail(
                    by_jid, r),
                retries=1)

    def _on_multi_status(self, by_jid: Dict[str, List[Tuple[WorkflowRun,
                                                            _StageRun, int]]],
                         d: Data) -> None:
        payload = self._checked_payload(d)
        if payload is None:
            # corrupted answer: re-arm every still-live member
            for entries in by_jid.values():
                for run, sr, attempt in entries:
                    if self._poll_live((run, sr, attempt)):
                        self._schedule_poll(run, sr, delay=self.poll_interval)
            return
        jobs = payload.get("jobs", {})
        for jid, entries in by_jid.items():
            status = jobs.get(jid)
            for run, sr, attempt in entries:
                if not self._poll_live((run, sr, attempt)):
                    continue
                if status is None or status.get("state") == "Unknown":
                    # the gateway no longer knows the job (restarted
                    # cluster): same recovery as a status loss — re-
                    # express the compute Interest
                    self._on_status_fail(run, sr, attempt, "unknown-job")
                else:
                    self._apply_status(run, sr, status)

    def _fan_status_fail(self, by_jid: Dict[str, List[Tuple[WorkflowRun,
                                                            _StageRun, int]]],
                         reason: str) -> None:
        for entries in by_jid.values():
            for run, sr, attempt in entries:
                if self._poll_live((run, sr, attempt)):
                    self._on_status_fail(run, sr, attempt, reason)

    def _poll(self, run: WorkflowRun, sr: _StageRun, attempt: int) -> None:
        if sr.status != StageStatus.RUNNING or sr.attempts != attempt \
                or run.failed is not None:
            return  # stage moved on (completed / re-submitted / aborted)
        status_name = Name.parse(sr.receipt["status_name"])
        self.status_interests += 1
        self.consumer.express(
            Interest(name=status_name, must_be_fresh=True, lifetime=2.0),
            on_data=lambda d, sr=sr, a=attempt: self._on_status(run, sr, a, d),
            on_fail=lambda r, sr=sr, a=attempt: self._on_status_fail(
                run, sr, a, r),
            retries=1)

    @staticmethod
    def _checked_payload(d: Data) -> Optional[Dict[str, Any]]:
        """Verify + decode a status answer; None means 'poll again'
        (the CS admission gate keeps corrupted Data out of caches)."""
        if verify_trusted(d) is False:
            return None
        try:
            return d.json()
        except (ValueError, UnicodeDecodeError):
            return None

    def _on_status(self, run: WorkflowRun, sr: _StageRun, attempt: int,
                   d: Data) -> None:
        if sr.status != StageStatus.RUNNING or sr.attempts != attempt:
            return
        payload = self._checked_payload(d)
        if payload is None:
            self._schedule_poll(run, sr, delay=self.poll_interval)
            return
        self._apply_status(run, sr, payload)

    def _apply_status(self, run: WorkflowRun, sr: _StageRun,
                      payload: Dict[str, Any]) -> None:
        state = payload.get("state")
        if state == "Completed":
            self._complete(run, sr)
        elif state == "Failed":
            self._trace(run, "stage-error", sr.inst.id,
                        str(payload.get("error", "unknown")))
            self._retry_or_fail(run, sr, f"executor:{payload.get('error')}")
        else:
            self._schedule_poll(run, sr, delay=self.poll_interval)

    def _on_status_fail(self, run: WorkflowRun, sr: _StageRun, attempt: int,
                        reason: str) -> None:
        """Status went dark — the serving cluster crashed or partitioned.

        Re-express the *compute* Interest: the canonical name routes to a
        surviving cluster, which re-executes exactly this stage (upstream
        results are already published under their own names)."""
        if sr.status != StageStatus.RUNNING or sr.attempts != attempt:
            return
        self._trace(run, "status-lost", sr.inst.id,
                    f"cluster={sr.cluster} reason={reason}")
        self._retry_or_fail(run, sr, f"status:{reason}")

    # ---------------------------------------------------------- completion
    def _complete(self, run: WorkflowRun, sr: _StageRun) -> None:
        sr.status = StageStatus.COMPLETE
        sr.completed_at = self.net.now
        self._trace(run, "stage-complete", sr.inst.id,
                    f"cluster={sr.cluster} cached={int(sr.from_cache)}")
        if (self.completion_model is not None and not sr.from_cache
                and sr.submitted_at is not None):
            self.completion_model.observe(
                dict(sr.inst.fields), face_id=-1,
                duration=self.net.now - sr.submitted_at)
        run.remaining -= 1
        for dep_id in run.dependents[sr.inst.id]:
            dsr = run.stages[dep_id]
            dsr.waiting_on -= 1
            if dsr.waiting_on == 0 and dsr.status == StageStatus.WAITING:
                self._launch(run, dsr)
        if run.remaining == 0:
            run.finished_at = self.net.now
            self._trace(run, "workflow-complete", run.workflow.name,
                        f"makespan={run.makespan:.6f}")
            if self.fetch_sink_results:
                self._fetch_sinks(run)

    def _fetch_sinks(self, run: WorkflowRun) -> None:
        """Sink payloads ride the windowed segment pipeline: a large
        (segmented) result streams in under the AIMD window while a small
        one falls back to a single bare-name fetch — same bytes either
        way, and intermediate Content Stores cache whatever the transfer
        touched at segment granularity."""
        for inst in run.workflow.sinks():
            def on_complete(blob: bytes, inst=inst) -> None:
                run.results[inst.id] = json.loads(bytes(blob).decode())
                self._trace(run, "result-fetched", inst.id, f"{len(blob)}B")

            SegmentFetcher(
                self.net, self.consumer.node, inst.result_name,
                consumer=self.consumer,
                # thread the engine's retry/lifetime policy through so a
                # flaky-network configuration covers the sink fetch too
                single_retries=self.express_retries,
                single_lifetime=self.interest_lifetime,
                max_retries=max(10, self.express_retries * 3),
                default_rto=self.interest_lifetime / 4,
                on_complete=on_complete,
                on_error=lambda r, inst=inst: self._trace(
                    run, "result-fetch-failed", inst.id, r)).start()
