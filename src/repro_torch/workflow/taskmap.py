"""Elastic map fan-out: ``map(fn, dataset)`` over thousands of named tasks.

A Lithops-shaped front end, built entirely
out of the paper's primitives — no coordinator, no per-platform plugin:

* **Partition discovery** reads the dataset's lake manifest and tiles its
  segment range into tasks (one task per ``spt`` contiguous segments).
  Each task is a canonical compute name carrying ``part=i``, so the §VII
  result cache dedupes re-runs, speculative duplicates and overlapping
  maps for free.
* **Batched submission** sends one ``/lidc/jobs/batch/<app>/<k=v&lo=&hi=>``
  Interest per ``batch_size`` tasks; the gateway validates/matchmakes the
  homogeneous template once, fans members out internally, and answers one
  signed batch receipt.  Per-task submission overhead is amortized ~100x.
* **The completion monitor** polls per *cluster*, not per task: one
  ``/lidc/status/<cluster>/batch/ids=...`` Interest per cadence returns
  every tracked batch's progress as compressed done ranges.
* **Speculative re-execution**: when a task's on-chip age exceeds
  ``spec_factor`` x the fleet-wide running median of completed-task
  durations, its canonical name is re-expressed with ``avoid=<cluster>``
  so it lands somewhere else.  Whichever replica finishes first publishes
  the canonical result name; the loser is absorbed by the result cache —
  exactly-once *effective* execution by construction, not by locking.

A batch whose status goes dark (cluster crash) is re-expressed under its
canonical batch name: routing lands it on a survivor, whose cache scan
skips the parts that already completed — crash recovery re-runs only the
lost work.

The port's copy of ``repro/workflow/taskmap.py``: the same logic, its imports
pointing inside ``repro_torch``.
"""

from __future__ import annotations

import bisect
import hashlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from ..core import reasons
from ..core.cluster import ComputeCluster, ExecPlan, ExecResult
from ..core.forwarder import Consumer, Forwarder, Network
from ..core.jobs import (AVOID_FIELD, INPUTS_FIELD, Job, JobSpec,
                         encode_input_names, expand_ranges, result_name_for)
from ..core.matchmaker import ServiceEndpoint
from ..core.names import (DATA_PREFIX, STATUS_PREFIX, Name, batch_job_name,
                          canonical_job_name)
from ..core.overlay import LidcSystem
from ..core.packets import Data, Interest, verify_trusted
from ..core.resilience import ENGINE_BUSY, ENGINE_NOROUTE, RetryPolicy
from ..core.strategy import AdaptiveStrategy, Strategy
from ..core.validation import ValidationError, ValidatorRegistry, default_registry
from .apps import ExecutionLog

__all__ = ["Partition", "plan_partitions", "TaskMapRun", "TaskMapExecutor",
           "taskmap_registry", "taskmap_endpoints", "build_taskmap_fleet",
           "register_fn", "TASKMAP_FNS", "MAP_APP", "REDUCE_APP"]

MAP_APP = "tm-map"
REDUCE_APP = "tm-reduce"

# virtual-time cost model (overridable per map via cost=)
MAP_THROUGHPUT = 8 * 2 ** 20    # bytes/second a map task chews through
TASK_BASE_S = 1e-3              # floor: no task is free
REDUCE_PER_PART_S = 2e-4        # reduce folds one part result per 0.2 ms


# ---------------------------------------------------------------------------
# the function registry: named, so a map's fn= travels inside the job name
# ---------------------------------------------------------------------------

# map fns take the task's list of bytes-like segment views and return a
# JSON-able dict; reduce fns take the list of per-part result payloads
TASKMAP_FNS: Dict[str, Callable[..., Dict[str, Any]]] = {}


def register_fn(name: str, fn: Callable[..., Dict[str, Any]]) -> None:
    TASKMAP_FNS[name] = fn


def _wordcount(views: Sequence[Any]) -> Dict[str, Any]:
    return {"count": sum(len(bytes(v).split()) for v in views)}


def _wordcount_reduce(values: Sequence[Mapping[str, Any]]) -> Dict[str, Any]:
    return {"count": sum(int(v.get("count", 0)) for v in values)}


register_fn("wordcount", _wordcount)
register_fn("wordcount-reduce", _wordcount_reduce)


# ---------------------------------------------------------------------------
# partition discovery
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Partition:
    """One task's slice of the dataset: segments [seg_lo, seg_hi) ==
    bytes [byte_lo, byte_hi)."""

    part: int
    seg_lo: int
    seg_hi: int
    byte_lo: int
    byte_hi: int


def plan_partitions(*, size: int, segments: int, segment_size: int,
                    tasks: Optional[int] = None) -> List[Partition]:
    """Tile a manifest's segment range into tasks — no gap, no overlap.

    ``tasks`` caps the task count (segments are the atom: at most one
    task per segment, each task a *contiguous* run of ``spt`` segments).
    The final task absorbs the tail, so byte ranges reassemble the
    dataset exactly."""
    if size < 0:
        raise ValueError(f"negative dataset size: {size}")
    if segments <= 1:
        return [Partition(0, 0, 1, 0, size)]
    want = segments if tasks is None else max(1, min(int(tasks), segments))
    spt = -(-segments // want)          # ceil: segments per task
    n = -(-segments // spt)
    return [Partition(p, p * spt, min(segments, (p + 1) * spt),
                      p * spt * segment_size,
                      min(size, (p + 1) * spt * segment_size))
            for p in range(n)]


# ---------------------------------------------------------------------------
# executors (run *inside* clusters, against the shared lake)
# ---------------------------------------------------------------------------

def _require_lake(cluster: ComputeCluster):
    if cluster.lake is None:
        raise RuntimeError("taskmap apps need a data lake attached")
    return cluster.lake


def make_map_executor(log: Optional[ExecutionLog] = None):
    def executor(job: Job, cluster: ComputeCluster) -> ExecPlan:
        lake = _require_lake(cluster)
        if log is not None:
            log.record(job, cluster, cluster.net.now)
        fields = job.spec.fields
        part = int(fields["part"])
        segs = int(fields.get("segs", 1))
        spt = int(fields.get("spt", 1))
        dataset = job.spec.input_names()[0]
        views: List[Any] = []
        if segs <= 1:
            v = lake.get_view(dataset)
            if v is None:
                raise FileNotFoundError(f"dataset {dataset} not in lake")
            views.append(v)
        else:
            # zero-copy: read exactly this task's segment keys — never
            # the reassembled whole object
            base = str(dataset)
            for i in range(part * spt, min(segs, (part + 1) * spt)):
                v = lake.store.get(f"{base}/seg={i}")
                if v is None:
                    raise FileNotFoundError(f"{base}/seg={i} not in lake")
                views.append(v)
        nbytes = sum(len(v) for v in views)
        cost = fields.get("cost")
        duration = (float(cost) if cost is not None
                    else max(TASK_BASE_S, nbytes / MAP_THROUGHPUT))
        fn = TASKMAP_FNS[str(fields.get("fn", "wordcount"))]
        box: Dict[str, Any] = {}

        def work() -> None:
            box["out"] = fn(views)

        def finalize() -> ExecResult:
            return ExecResult(payload={"app": MAP_APP, "part": part,
                                       "bytes": nbytes, **box["out"]},
                              duration=0.0)

        return ExecPlan(phases=[(duration, work)], finalize=finalize)

    return executor


def make_reduce_executor(log: Optional[ExecutionLog] = None):
    def executor(job: Job, cluster: ComputeCluster) -> ExecPlan:
        lake = _require_lake(cluster)
        if log is not None:
            log.record(job, cluster, cluster.net.now)
        index_name = job.spec.input_names()[0]
        index = lake.get_json(index_name)
        if index is None:
            raise FileNotFoundError(f"reduce index {index_name} not in lake")
        part_names = [Name.parse(p) for p in index["parts"]]
        fn = TASKMAP_FNS[str(job.spec.fields.get("fn", "wordcount-reduce"))]
        duration = max(TASK_BASE_S, REDUCE_PER_PART_S * len(part_names))
        values: List[Dict[str, Any]] = []
        box: Dict[str, Any] = {}

        def work() -> None:
            for n in part_names:
                obj = lake.get_json(n)
                if obj is None:
                    raise FileNotFoundError(f"part result {n} not in lake")
                values.append(obj)
            box["out"] = fn(values)

        def finalize() -> ExecResult:
            return ExecResult(payload={"app": REDUCE_APP,
                                       "parts": len(part_names),
                                       **box["out"]},
                              duration=0.0)

        return ExecPlan(phases=[(duration, work)], finalize=finalize)

    return executor


# ---------------------------------------------------------------------------
# validators + fleet assembly
# ---------------------------------------------------------------------------

def validate_tm_map(fields, caps) -> None:
    if not str(fields.get(INPUTS_FIELD, "")):
        raise ValidationError("tm-map requires in= (the dataset name)")
    if int(fields.get("part", -1)) < 0:
        raise ValidationError("tm-map requires part= >= 0")
    if str(fields.get("fn", "wordcount")) not in TASKMAP_FNS:
        raise ValidationError(f"unknown map fn: {fields.get('fn')}")


def validate_tm_reduce(fields, caps) -> None:
    if not str(fields.get(INPUTS_FIELD, "")):
        raise ValidationError("tm-reduce requires in= (the index name)")
    if str(fields.get("fn", "wordcount-reduce")) not in TASKMAP_FNS:
        raise ValidationError(f"unknown reduce fn: {fields.get('fn')}")


def taskmap_registry(base: Optional[ValidatorRegistry] = None
                     ) -> ValidatorRegistry:
    reg = base or default_registry()
    reg.register(MAP_APP, validate_tm_map)
    reg.register(REDUCE_APP, validate_tm_reduce)
    return reg


def taskmap_endpoints(log: Optional[ExecutionLog] = None
                      ) -> List[ServiceEndpoint]:
    return [
        ServiceEndpoint(service="tm-map.lidck8s.svc.cluster.local",
                        app=MAP_APP, executor=make_map_executor(log)),
        ServiceEndpoint(service="tm-reduce.lidck8s.svc.cluster.local",
                        app=REDUCE_APP, executor=make_reduce_executor(log)),
    ]


def build_taskmap_fleet(n_clusters: int = 4, *, chips: int = 8,
                        strategy: Optional[Strategy] = None,
                        latencies: Optional[Sequence[float]] = None,
                        segment_size: Optional[int] = None,
                        max_queue_depth: int = 4096,
                        engine: str = "calendar"
                        ) -> Tuple[LidcSystem, ExecutionLog]:
    """A LIDC overlay whose clusters serve the taskmap apps.

    Defaults tuned for fan-out: deep queued admission (a batch parks its
    members Pending and drains them wave by wave) and a cold-probe-
    rotating adaptive strategy so concurrent cold batch names spread
    across clusters instead of piling onto the cheapest."""
    if strategy is None:
        strategy = AdaptiveStrategy(probe_fanout=1, rotate_cold_probes=True)
    system = LidcSystem(strategy=strategy, engine=engine)
    if segment_size is not None:
        system.lake.segment_size = max(1, int(segment_size))
    log = ExecutionLog()
    validators = taskmap_registry()
    for i in range(n_clusters):
        lat = latencies[i] if latencies else 0.002 + 0.0005 * i
        system.add_cluster(f"tmpod{i}", chips=chips, latency=lat,
                           endpoints=taskmap_endpoints(log),
                           validators=validators,
                           max_queue_depth=max_queue_depth)
    return system, log


# ---------------------------------------------------------------------------
# the front end
# ---------------------------------------------------------------------------

@dataclass
class _BatchTrack:
    lo: int
    hi: int
    attempts: int = 0
    bid: Optional[str] = None
    cluster: Optional[str] = None
    noroute_retries: int = 0
    busy_retries: int = 0
    poll_fails: int = 0

    def parts(self) -> range:
        return range(self.lo, self.hi)


@dataclass
class TaskMapRun:
    """Observable state of one ``map`` / ``map_reduce`` invocation."""

    fn: str
    dataset: Name
    template: Dict[str, Any] = field(default_factory=dict)
    partitions: List[Partition] = field(default_factory=list)
    started_at: float = 0.0
    submit_done_at: Optional[float] = None     # all batch receipts in
    finished_at: Optional[float] = None
    failed: Optional[str] = None
    # part -> virtual completion time (as observed by the monitor)
    done: Dict[int, float] = field(default_factory=dict)
    cached: set = field(default_factory=set)   # absorbed by the result cache
    task_durs: Dict[int, float] = field(default_factory=dict)  # on-chip, real
    speculated: Dict[int, str] = field(default_factory=dict)   # part -> avoided
    spec_wins: int = 0                         # duplicate beat the straggler
    retrying: set = field(default_factory=set)
    reduce_result: Optional[Dict[str, Any]] = None
    batches: List[_BatchTrack] = field(default_factory=list)
    # sorted completed on-chip durations — THIS run's speculation
    # baseline (runs with different cost profiles must not share a p50)
    dur_samples: List[float] = field(default_factory=list)

    @property
    def tasks(self) -> int:
        return len(self.partitions)

    @property
    def delivery(self) -> float:
        return len(self.done) / max(1, self.tasks)

    @property
    def complete(self) -> bool:
        return self.failed is None and len(self.done) >= self.tasks

    @property
    def makespan(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.started_at

    def signature(self) -> str:
        """Digest of the map's template — names the reduce index."""
        name = canonical_job_name(self.template)
        return hashlib.sha256(str(name).encode()).hexdigest()[:16]


class TaskMapExecutor:
    """Compile ``map(fn, dataset)`` into batched compute Interests and
    monitor them to completion (see module docstring)."""

    def __init__(self, net: Network, node: Forwarder, *, lake=None,
                 name: str = "taskmap",
                 poll_interval: float = 0.25,
                 interest_lifetime: float = 4.0,
                 batch_size: int = 128,
                 max_batch_attempts: int = 6,
                 speculation: bool = True,
                 spec_factor: float = 3.0,
                 spec_min_samples: int = 8,
                 express_retries: int = 3,
                 noroute_policy: RetryPolicy = ENGINE_NOROUTE,
                 busy_policy: RetryPolicy = ENGINE_BUSY):
        self.net = net
        self.consumer = Consumer(net, node, name=name)
        self.lake = lake        # client-side handle (reduce index + results)
        self.poll_interval = poll_interval
        self.interest_lifetime = interest_lifetime
        self.batch_size = max(1, int(batch_size))
        self.max_batch_attempts = max_batch_attempts
        self.speculation = speculation
        self.spec_factor = spec_factor
        self.spec_min_samples = max(1, int(spec_min_samples))
        self.express_retries = express_retries
        self.noroute_policy = noroute_policy
        self.busy_policy = busy_policy
        self._busy_delays = busy_policy.scaled(poll_interval)
        # observability: how much protocol traffic the fan-out cost
        self.submit_interests = 0
        self.status_interests = 0
        self.single_submits = 0
        # per-cluster monitor groups: cluster -> {"batches": {bid: (run,
        # track)}, "jobs": {job_id: (run, part)}}; one timer per cluster
        self._groups: Dict[str, Dict[str, Dict[str, Any]]] = {}
        self._armed: set = set()

    @classmethod
    def for_system(cls, system: LidcSystem, **kw) -> "TaskMapExecutor":
        return cls(system.net, system.overlay.edge, lake=system.lake, **kw)

    # ------------------------------------------------------------------ api
    def map(self, fn: str, dataset, *, tasks: Optional[int] = None,
            cost: Optional[float] = None) -> TaskMapRun:
        """Run ``fn`` over every partition of ``dataset``; drives the
        network to quiescence and returns the completed run."""
        run = self.start_map(fn, dataset, tasks=tasks, cost=cost)
        self.net.run()
        return run

    def map_reduce(self, fn: str, reduce_fn: str, dataset, *,
                   tasks: Optional[int] = None,
                   cost: Optional[float] = None) -> TaskMapRun:
        """``map`` then fold the per-part results with ``reduce_fn`` (one
        ordinary compute job over a published index of result names)."""
        run = self.start_map(fn, dataset, tasks=tasks, cost=cost,
                             reduce_fn=reduce_fn)
        self.net.run()
        return run

    def start_map(self, fn: str, dataset, *, tasks: Optional[int] = None,
                  cost: Optional[float] = None,
                  reduce_fn: Optional[str] = None) -> TaskMapRun:
        """Async entry: discover partitions, then fan out.  Callers must
        drive ``net`` themselves."""
        dataset = dataset if isinstance(dataset, Name) \
            else Name.parse(str(dataset))
        run = TaskMapRun(fn=fn, dataset=dataset, started_at=self.net.now)
        run._reduce_fn = reduce_fn      # type: ignore[attr-defined]
        run._cost = cost                # type: ignore[attr-defined]
        run._tasks = tasks              # type: ignore[attr-defined]
        self._discover(run)
        return run

    # ------------------------------------------------- partition discovery
    def _discover(self, run: TaskMapRun) -> None:
        manifest_name = run.dataset.append("manifest")

        def on_manifest(d: Data) -> None:
            if verify_trusted(d) is False:
                return self._fail(run, "manifest:corrupt")
            try:
                man = d.json()
                size = int(man["size"])
                segments = int(man["segments"])
                segment_size = int(man["segment_size"])
            except (ValueError, KeyError, TypeError, UnicodeDecodeError):
                return self._fail(run, "manifest:malformed")
            self._plan_and_submit(run, size=size, segments=segments,
                                  segment_size=segment_size)

        def on_manifest_fail(reason: str) -> None:
            # small datasets are stored unsegmented — no manifest; fall
            # back to fetching the object itself for its size
            self.consumer.express(
                Interest(name=run.dataset, lifetime=self.interest_lifetime),
                on_data=lambda d: self._plan_and_submit(
                    run, size=len(d.content), segments=1, segment_size=1),
                on_fail=lambda r: self._fail(run, f"dataset:{r}"),
                retries=self.express_retries)

        self.consumer.express(
            Interest(name=manifest_name, lifetime=self.interest_lifetime),
            on_data=on_manifest, on_fail=on_manifest_fail,
            retries=self.express_retries)

    def _plan_and_submit(self, run: TaskMapRun, *, size: int, segments: int,
                         segment_size: int) -> None:
        if run.failed is not None:
            return
        run.partitions = plan_partitions(
            size=size, segments=segments, segment_size=segment_size,
            tasks=run._tasks)                   # type: ignore[attr-defined]
        n = len(run.partitions)
        spt = run.partitions[0].seg_hi - run.partitions[0].seg_lo
        run.template = {"app": MAP_APP, "fn": run.fn,
                        INPUTS_FIELD: encode_input_names([run.dataset]),
                        "parts": n, "segs": segments, "spt": spt}
        cost = run._cost                        # type: ignore[attr-defined]
        if cost is not None:
            run.template["cost"] = cost
        for lo in range(0, n, self.batch_size):
            b = _BatchTrack(lo=lo, hi=min(n, lo + self.batch_size))
            run.batches.append(b)
            self._express_batch(run, b)

    # --------------------------------------------------- batched submission
    def _express_batch(self, run: TaskMapRun, b: _BatchTrack) -> None:
        if run.failed is not None:
            return
        b.attempts += 1
        name = batch_job_name(run.template, b.lo, b.hi)
        self.submit_interests += 1
        self.consumer.express(
            Interest(name=name, lifetime=self.interest_lifetime,
                     must_be_fresh=True),
            on_data=lambda d: self._on_batch_receipt(run, b, d),
            on_fail=lambda r: self._on_batch_fail(run, b, r),
            retries=self.express_retries)

    def _on_batch_receipt(self, run: TaskMapRun, b: _BatchTrack, d: Data
                          ) -> None:
        if run.failed is not None:
            return
        if verify_trusted(d) is False:
            return self._on_batch_fail(run, b, "corrupt-receipt")
        try:
            receipt = d.json()
        except (ValueError, UnicodeDecodeError):
            return self._on_batch_fail(run, b, "corrupt-receipt")
        b.bid = receipt.get("batch_id")
        b.cluster = receipt.get("cluster")
        b.poll_fails = 0
        for part in expand_ranges(receipt.get("cached", [])):
            if b.lo <= part < b.hi:
                run.cached.add(part)
                self._mark_done(run, part)
        if receipt.get("state") == "Completed":
            for part in b.parts():
                self._mark_done(run, part)
        if run.submit_done_at is None and all(x.bid is not None
                                              for x in run.batches):
            run.submit_done_at = self.net.now
        if any(p not in run.done for p in b.parts()):
            group = self._group(b.cluster)
            group["batches"][b.bid] = (run, b)
            self._arm(b.cluster)
        self._maybe_finish(run)

    def _on_batch_fail(self, run: TaskMapRun, b: _BatchTrack, reason: str
                       ) -> None:
        if run.failed is not None or all(p in run.done for p in b.parts()):
            return
        if (reasons.is_no_route_failure(reason)
                and self.noroute_policy.allows(b.noroute_retries + 1)):
            # routes still gossiping: free retry
            b.noroute_retries += 1
            b.attempts -= 1
            return self._express_batch(run, b)
        if (reasons.is_busy_failure(reason)
                and self.busy_policy.allows(b.busy_retries + 1)):
            # the fleet is saturated, not broken: back off, re-express;
            # the retried Interest re-ranks by the quoted ETAs
            b.busy_retries += 1
            b.attempts -= 1
            attempt = b.attempts
            self.net.schedule(
                self._busy_delays.delay(b.busy_retries),
                lambda: (b.attempts == attempt and b.bid is None
                         and self._express_batch(run, b)))
            return
        if b.attempts < self.max_batch_attempts:
            return self._express_batch(run, b)
        self._fail(run, f"batch[{b.lo},{b.hi}):{reason}")

    # ----------------------------------------------------------- monitoring
    def _group(self, cluster: str) -> Dict[str, Dict[str, Any]]:
        return self._groups.setdefault(cluster,
                                       {"batches": {}, "jobs": {}})

    def _arm(self, cluster: str) -> None:
        if cluster in self._armed:
            return
        self._armed.add(cluster)
        self.net.schedule(self.poll_interval,
                          lambda: self._fire(cluster))

    def _fire(self, cluster: str) -> None:
        """One poll cadence for everything tracked at ``cluster``: at
        most one batch multi-status and one job multi-status Interest."""
        self._armed.discard(cluster)
        group = self._groups.get(cluster)
        if not group:
            return
        live_batches = {bid: rb for bid, rb in group["batches"].items()
                        if rb[0].failed is None
                        and any(p not in rb[0].done for p in rb[1].parts())}
        live_jobs = {jid: rp for jid, rp in group["jobs"].items()
                     if rp[0].failed is None and rp[1] not in rp[0].done}
        group["batches"] = dict(live_batches)
        group["jobs"] = dict(live_jobs)
        if not live_batches and not live_jobs:
            self._groups.pop(cluster, None)
            return
        pending = {"n": (1 if live_batches else 0) + (1 if live_jobs else 0)}

        def rearm() -> None:
            pending["n"] -= 1
            if pending["n"] <= 0:
                g = self._groups.get(cluster)
                if g and (g["batches"] or g["jobs"]):
                    self._arm(cluster)

        base = Name.parse(STATUS_PREFIX).append(cluster)
        if live_batches:
            name = base.append("batch",
                               "ids=" + ",".join(sorted(live_batches)))
            self.status_interests += 1
            self.consumer.express(
                Interest(name=name, must_be_fresh=True, lifetime=2.0),
                on_data=lambda d: (self._on_batch_statuses(
                    cluster, live_batches, d), rearm()),
                on_fail=lambda r: (self._on_batch_poll_fail(
                    cluster, live_batches, r), rearm()),
                retries=1)
        if live_jobs:
            name = base.append("ids=" + ",".join(sorted(live_jobs)))
            self.status_interests += 1
            self.consumer.express(
                Interest(name=name, must_be_fresh=True, lifetime=2.0),
                on_data=lambda d: (self._on_job_statuses(
                    cluster, live_jobs, d), rearm()),
                on_fail=lambda r: (self._on_job_poll_fail(
                    cluster, live_jobs, r), rearm()),
                retries=1)

    def _on_batch_statuses(self, cluster: str, tracked: Dict[str, Tuple],
                           d: Data) -> None:
        if verify_trusted(d) is False:
            return
        try:
            payload = d.json()
        except (ValueError, UnicodeDecodeError):
            return
        statuses = payload.get("batches", {})
        for bid, (run, b) in tracked.items():
            if run.failed is not None:
                continue
            st = statuses.get(bid)
            if st is None or st.get("state") == "Unknown":
                self._batch_lost(run, b, "unknown-batch")
                continue
            self._apply_batch_status(run, b, st)

    def _apply_batch_status(self, run: TaskMapRun, b: _BatchTrack,
                            st: Dict[str, Any]) -> None:
        b.poll_fails = 0
        for part in expand_ranges(st.get("done_ranges", [])):
            if b.lo <= part < b.hi:
                self._observe_duration(run, part,
                                       st.get("durs", {}).get(str(part)))
                self._mark_done(run, part)
        # surviving durs for parts marked done in earlier polls
        for pstr, dur in st.get("durs", {}).items():
            self._observe_duration(run, int(pstr), dur)
        for pstr in st.get("failed", {}):
            part = int(pstr)
            if part not in run.done and part not in run.retrying:
                run.retrying.add(part)
                self._launch_single(run, part)
        if self.speculation:
            self._check_stragglers(run, b, st.get("running", {}))
        self._maybe_finish(run)

    def _observe_duration(self, run: TaskMapRun, part: int,
                          dur: Optional[float]) -> None:
        if dur is None or part in run.task_durs:
            return
        run.task_durs[part] = float(dur)
        bisect.insort(run.dur_samples, float(dur))

    def _check_stragglers(self, run: TaskMapRun, b: _BatchTrack,
                          running: Dict[str, float]) -> None:
        """On-chip age vs. this run's running median of completed
        durations: a task ``spec_factor`` x past the median is presumed
        straggling — re-express its canonical name away from its cluster.
        The median needs ``spec_min_samples`` completions first, so an
        empty fleet never mass-speculates its opening wave."""
        if len(run.dur_samples) < self.spec_min_samples:
            return
        p50 = run.dur_samples[len(run.dur_samples) // 2]
        threshold = self.spec_factor * p50
        now = self.net.now
        for pstr, started in running.items():
            part = int(pstr)
            if (part in run.done or part in run.speculated
                    or part in run.retrying):
                continue
            if now - float(started) > threshold:
                run.speculated[part] = b.cluster or ""
                self._launch_single(run, part, avoid=b.cluster)

    def _on_batch_poll_fail(self, cluster: str, tracked: Dict[str, Tuple],
                            reason: str) -> None:
        for bid, (run, b) in tracked.items():
            if run.failed is not None:
                continue
            b.poll_fails += 1
            if b.poll_fails >= 2:
                self._batch_lost(run, b, reason)

    def _batch_lost(self, run: TaskMapRun, b: _BatchTrack, reason: str
                    ) -> None:
        """The batch's cluster went dark: re-express the canonical batch
        name.  Routing lands it on a survivor whose result-cache scan
        skips every part that already completed — only lost work reruns."""
        if all(p in run.done for p in b.parts()):
            return
        group = self._groups.get(b.cluster or "")
        if group is not None:
            group["batches"].pop(b.bid, None)
        b.bid = None
        b.cluster = None
        b.poll_fails = 0
        if b.attempts < self.max_batch_attempts:
            self._express_batch(run, b)
        else:
            self._fail(run, f"batch[{b.lo},{b.hi}):lost:{reason}")

    # --------------------------------------- single-task retry/speculation
    def _launch_single(self, run: TaskMapRun, part: int,
                       avoid: Optional[str] = None, attempt: int = 1) -> None:
        """Re-express one task's canonical compute name (failure retry or
        speculative duplicate).  The name is identical to the batch
        member's, so the §VII result cache and the gateways' running-
        dedupe keep effective execution exactly-once."""
        if run.failed is not None or part in run.done:
            return
        fields = {**run.template, "part": part}
        if avoid:
            fields[AVOID_FIELD] = avoid
        name = canonical_job_name(fields)
        self.single_submits += 1
        state = {"busy": 0, "noroute": 0}

        def on_receipt(d: Data) -> None:
            if run.failed is not None or part in run.done:
                return
            if verify_trusted(d) is False:
                return on_fail("corrupt-receipt")
            try:
                receipt = d.json()
            except (ValueError, UnicodeDecodeError):
                return on_fail("corrupt-receipt")
            if receipt.get("state") == "Completed":
                # absorbed by the result cache (the original finished
                # first) — by construction not a second execution
                run.retrying.discard(part)
                self._mark_done(run, part)
                self._maybe_finish(run)
                return
            cluster = receipt.get("cluster")
            jid = receipt.get("job_id")
            if cluster and jid:
                self._group(cluster)["jobs"][jid] = (run, part)
                self._arm(cluster)

        def on_fail(reason: str) -> None:
            if run.failed is not None or part in run.done:
                return
            if (reasons.is_no_route_failure(reason)
                    and self.noroute_policy.allows(state["noroute"] + 1)):
                state["noroute"] += 1
                return express()
            if (reasons.is_busy_failure(reason)
                    and self.busy_policy.allows(state["busy"] + 1)):
                state["busy"] += 1
                self.net.schedule(self._busy_delays.delay(state["busy"]),
                                  express)
                return
            if attempt < self.max_batch_attempts:
                self._launch_single(run, part, avoid=avoid,
                                    attempt=attempt + 1)
            else:
                run.retrying.discard(part)
                run.speculated.pop(part, None)  # give the original its shot

        def express() -> None:
            if run.failed is not None or part in run.done:
                return
            self.consumer.express(
                Interest(name=name, lifetime=self.interest_lifetime,
                         must_be_fresh=True),
                on_data=on_receipt, on_fail=on_fail,
                retries=self.express_retries)

        express()

    def _on_job_statuses(self, cluster: str, tracked: Dict[str, Tuple],
                         d: Data) -> None:
        if verify_trusted(d) is False:
            return
        try:
            payload = d.json()
        except (ValueError, UnicodeDecodeError):
            return
        jobs = payload.get("jobs", {})
        for jid, (run, part) in tracked.items():
            if run.failed is not None or part in run.done:
                continue
            st = jobs.get(jid)
            if st is None or st.get("state") == "Unknown":
                self._single_lost(run, part, cluster, jid)
                continue
            state = st.get("state")
            if state == "Completed":
                if part in run.speculated:
                    # the duplicate beat the straggler to the canonical
                    # result name — a speculation win
                    run.spec_wins += 1
                run.retrying.discard(part)
                self._mark_done(run, part)
                self._maybe_finish(run)
            elif state == "Failed":
                self._single_lost(run, part, cluster, jid)

    def _on_job_poll_fail(self, cluster: str, tracked: Dict[str, Tuple],
                          reason: str) -> None:
        for jid, (run, part) in tracked.items():
            if run.failed is None and part not in run.done:
                self._single_lost(run, part, cluster, jid)

    def _single_lost(self, run: TaskMapRun, part: int, cluster: str,
                     jid: str) -> None:
        group = self._groups.get(cluster)
        if group is not None:
            group["jobs"].pop(jid, None)
        avoid = run.speculated.get(part)
        self._launch_single(run, part, avoid=avoid)

    # ----------------------------------------------------------- completion
    def _mark_done(self, run: TaskMapRun, part: int) -> None:
        if part not in run.done:
            run.done[part] = self.net.now
            run.retrying.discard(part)

    def _maybe_finish(self, run: TaskMapRun) -> None:
        if run.failed is not None or run.finished_at is not None:
            return
        if not run.partitions or len(run.done) < run.tasks:
            return
        run.finished_at = self.net.now
        reduce_fn = getattr(run, "_reduce_fn", None)
        if reduce_fn is not None:
            self._submit_reduce(run, reduce_fn)

    def _fail(self, run: TaskMapRun, reason: str) -> None:
        if run.failed is None:
            run.failed = reason

    # --------------------------------------------------------------- reduce
    def _submit_reduce(self, run: TaskMapRun, reduce_fn: str,
                       attempt: int = 1) -> None:
        """Fold the map's results: publish an index of the per-part
        result names, then submit one ordinary ``tm-reduce`` job over it.
        The index is named by the map template's digest, so identical
        map_reduce invocations share one reduce result via the cache."""
        if self.lake is None:
            self._fail(run, "reduce:no-lake-handle")
            return
        msig = run.signature()
        index_name = Name.parse(DATA_PREFIX).append("taskmap", msig, "index")
        if not self.lake.has(index_name):
            part_names = [
                str(result_name_for(JobSpec(
                    app=MAP_APP,
                    fields={k: v for k, v in {**run.template,
                                              "part": p.part}.items()
                            if k != "app"})))
                for p in run.partitions]
            self.lake.put_json(index_name, {"parts": part_names,
                                            "tasks": run.tasks})
        fields = {"app": REDUCE_APP, "fn": reduce_fn,
                  INPUTS_FIELD: encode_input_names([index_name]),
                  "parts": run.tasks, "msig": msig}
        spec = JobSpec(app=REDUCE_APP,
                       fields={k: v for k, v in fields.items() if k != "app"})
        name = canonical_job_name(fields)

        def finish() -> None:
            run.reduce_result = self.lake.get_json(result_name_for(spec))
            if run.reduce_result is None:
                retry("result-missing")

        def retry(reason: str) -> None:
            if attempt < self.max_batch_attempts:
                self.net.schedule(
                    self.poll_interval,
                    lambda: self._submit_reduce(run, reduce_fn,
                                                attempt=attempt + 1))
            else:
                self._fail(run, f"reduce:{reason}")

        def poll(status_name: Name) -> None:
            self.status_interests += 1
            self.consumer.express(
                Interest(name=status_name, must_be_fresh=True, lifetime=2.0),
                on_data=on_status, on_fail=lambda r: retry(r), retries=1)

        def on_status(d: Data) -> None:
            if verify_trusted(d) is False:
                return retry("corrupt-status")
            try:
                st = d.json()
            except (ValueError, UnicodeDecodeError):
                return retry("corrupt-status")
            state = st.get("state")
            if state == "Completed":
                finish()
            elif state in ("Failed", "Unknown"):
                retry(str(st.get("error", state)))
            else:
                self.net.schedule(
                    self.poll_interval,
                    lambda: poll(Name.parse(status_name_box["n"])))

        status_name_box: Dict[str, str] = {}

        def on_receipt(d: Data) -> None:
            if verify_trusted(d) is False:
                return retry("corrupt-receipt")
            try:
                receipt = d.json()
            except (ValueError, UnicodeDecodeError):
                return retry("corrupt-receipt")
            if receipt.get("state") == "Completed":
                return finish()
            status_name_box["n"] = receipt["status_name"]
            self.net.schedule(
                self.poll_interval,
                lambda: poll(Name.parse(status_name_box["n"])))

        self.submit_interests += 1
        self.consumer.express(
            Interest(name=name, lifetime=self.interest_lifetime,
                     must_be_fresh=True),
            on_data=on_receipt, on_fail=lambda r: retry(r),
            retries=self.express_retries)
