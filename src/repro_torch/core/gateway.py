"""The cluster gateway (paper §III.C, Fig. 4): parse → validate → spawn.

"The Gateway acts as a decision-maker, determining how to process the
incoming Interest.  If the Interest relates to computational tasks, the
Gateway parses the Interest to understand details such as the specific
application to be activated, the target dataset, and other application
parameters like memory capacity and CPU needs.  Once these details are
clear, the Gateway initiates a Kubernetes job."

Our gateway attaches four producers to the cluster's forwarder node:

* ``/lidc/compute`` — parse the semantic name, run the per-app validator,
  check the result cache, matchmake to a named endpoint, admit, and answer
  with a signed *receipt* (job_id + ETA + where status/results will live).
* ``/lidc/jobs/batch`` — batched submission: one Interest admits a
  homogeneous ``part=[lo,hi)`` task range; validation, matchmaking and
  the run estimate are paid once per batch, the answer is one signed
  batch receipt, and progress is polled as compressed done ranges.
* ``/lidc/status/<job_id>`` — the paper's four-state status protocol,
  plus ``ids=`` multi-job and ``batch/<bid>`` range answers.
* ``/lidc/data`` — delegated to the data lake (the fileserver pod).

Saturation is a first-class network signal here, not a dead end:

* A feasible-but-saturated cluster answers with a **busy receipt** — a
  Nack whose ``info`` carries the scheduler's predicted completion time
  (``eta``) and live load — so strategies upstream rank clusters by
  transfer cost *plus predicted completion* instead of blindly
  retrying.  (``legacy_nack=True`` restores the historical bare
  ``no-capacity:`` Nack; the property tests prove the two paths admit
  and execute identically.)
* Past the scheduler's **spill threshold**, the gateway *re-expresses
  the compute Interest upstream* through its own forwarder
  (``skip_local``), shedding the work toward peer clusters with no
  controller involved.  The hop-carried ``spill=`` path field bounds the
  shed chain and suppresses loops (a gateway that finds itself in the
  path answers busy instead of forwarding the work in a circle), and the
  peer's receipt is republished under the original Interest name, so the
  client transparently lands on the peer's status namespace.

The port's copy of ``repro/core/gateway.py``: the same logic, its imports
pointing inside ``repro_torch``.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

from . import reasons
from .cluster import ComputeCluster
from .forwarder import Consumer, Nack
from .jobs import (AVOID_FIELD, SPILL_FIELD, Job, JobSpec, JobState,
                   compress_ranges, decode_spill_path, encode_spill_path,
                   result_name_for)
from .matchmaker import CapacityError, MatchError
from .names import (BATCH_PREFIX, COMPUTE_PREFIX, SERVE_PREFIX, STATUS_PREFIX,
                    Name, batch_fields_of, canonical_job_name, job_fields_of,
                    serve_fields_of)
from .packets import Data, Interest, sign_data
from .resilience import SPILL_RETRY
from .validation import ValidationError, ValidatorRegistry, default_registry

__all__ = ["Gateway", "MAX_BATCH_MEMBERS", "MAX_STATUS_IDS"]

# the largest [lo, hi) range one batch Interest may carry — a client
# fanning out 10k tasks sends ceil(10k / batch) batch Interests, it does
# not get to make one gateway admit the whole map in a single call
MAX_BATCH_MEMBERS = 1024

# the most job/batch ids one ids= multi-status Interest may select
MAX_STATUS_IDS = 256

# terminal batch records kept for retransmit dedupe / late polls before
# the oldest are evicted
MAX_BATCH_RECORDS = 512

# completed-task durations reported per batch status answer (a bounded
# recent window — the straggler monitor needs a p50 sample, not the full
# duration history of a 10k-task map)
MAX_REPORTED_DURS = 128


class Gateway:
    def __init__(self, cluster: ComputeCluster,
                 validators: Optional[ValidatorRegistry] = None,
                 signing_key: bytes = b"lidc-gateway-key",
                 legacy_nack: bool = False):
        self.cluster = cluster
        self.validators = validators or default_registry()
        self.key = signing_key
        self.legacy_nack = legacy_nack
        self.receipts_served = 0
        self.cache_shortcuts = 0
        self.busy_receipts = 0
        self.spills = 0
        self.spill_failures = 0
        self.brownouts = 0
        self.rejections: Dict[str, int] = {}
        self.batch_receipts = 0
        self.avoided = 0
        self._jobs_by_sig: Dict[str, str] = {}
        # batched-submission bookkeeping: bid -> record (insertion order,
        # terminal records evicted past MAX_BATCH_RECORDS), plus the
        # member index completion hooks update
        self._batches: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._batch_member: Dict[str, tuple] = {}   # job_id -> (bid, part)
        self._spill_consumer: Optional[Consumer] = None
        node = cluster.node
        node.attach_producer(Name.parse(COMPUTE_PREFIX), self._on_compute)
        # inference sessions are ordinary compute Interests under the
        # model-rooted serve namespace; same parse→validate→admit pipeline
        node.attach_producer(Name.parse(SERVE_PREFIX), self._on_compute)
        node.attach_producer(Name.parse(BATCH_PREFIX), self._on_batch)
        node.attach_producer(Name.parse(STATUS_PREFIX), self._on_status)
        if cluster.lake is not None:
            cluster.lake.attach(node)
        # evict the dedupe map when a job completes or fails — without
        # this the map grows forever and a finished signature shadows
        # later bookkeeping (see tests/test_gateway_protocol.py)
        cluster.scheduler.on_job_done.append(self._evict_sig)
        cluster.scheduler.on_job_done.append(self._on_member_done)

    # ------------------------------------------------------------- compute
    def _on_compute(self, interest: Interest, publish: Callable[[Data], None],
                    now: float):
        fields = job_fields_of(interest.name)
        if fields is None:
            fields = serve_fields_of(interest.name)
        if fields is None:
            return self._reject(interest, reasons.MALFORMED_JOB_NAME)
        app = fields.pop("app")
        # the hop-carried spill path and the speculation avoid list are
        # transport metadata: strip them before validation/spec so the
        # work keeps its canonical identity
        spill_path = decode_spill_path(fields.pop(SPILL_FIELD, ""))
        avoid = decode_spill_path(fields.pop(AVOID_FIELD, ""))
        # 1. application-specific validation (paper §IV.B) — against the
        #    *advertised* capability record, the same one the routing
        #    protocol gossiped: what the network was promised is what the
        #    gateway honors, even if the hardware underneath differs
        try:
            self.validators.validate(app, fields,
                                     self.cluster.capability_record())
        except ValidationError as e:
            return self._reject(interest, reasons.validation_reason(e))
        spec = JobSpec(app=app, fields=fields)
        # 2. result cache: identical canonical request already computed?
        #    (paper §VII: "identical requests ... uniquely identifying names")
        if self.cluster.lake is not None:
            rname = result_name_for(spec)
            if self.cluster.lake.has(rname):
                self.cache_shortcuts += 1
                cached = self.cluster.lake.get_json(rname) or {}
                return self._receipt(interest, now, state="Completed",
                                     job_id=cached.get("job_id", "cached"),
                                     spec=spec)
        # 2b. speculation steering: a duplicate fleeing a straggler must
        #     not land back on it — and crucially must not dedupe onto
        #     the straggling run below — so an avoided cluster answers
        #     busy.  (The cache check above still short-circuits: if the
        #     "straggler" finished in the meantime, the duplicate is
        #     absorbed by the §VII result cache, which is exactly the
        #     exactly-once mechanism speculation leans on.)
        if self.cluster.name in avoid:
            self.avoided += 1
            return self._busy(interest, spec, reason_detail="avoided")
        # 3. same canonical job already running here? return its receipt
        #    (dedupes multicast duplicates and client retransmissions)
        sig = spec.signature()
        existing_id = self._jobs_by_sig.get(sig)
        if existing_id is not None:
            job = self.cluster.jobs.get(existing_id)
            if job is not None and job.state not in (JobState.FAILED,):
                return self._receipt(interest, now, state=job.state.value,
                                     job_id=job.job_id, spec=spec, job=job)
        # 4. loop suppression: a spilled Interest that finds this cluster
        #    already on its path must not circulate — answer busy with our
        #    current ETA so the sender's strategy learns, never re-shed
        if self.cluster.name in spill_path:
            return self._busy(interest, spec, reason_detail="spill-loop")
        if not self.cluster.alive:
            return self._reject(interest, reasons.CLUSTER_DOWN)
        # 5. brownout: under sustained overload the gateway degrades
        #    gracefully — the lowest waiting priority classes are shed
        #    with busy receipts whose quoted ETA grows with the overload
        #    level, so low-priority callers back way off while urgent
        #    classes keep being admitted (nobody times out uniformly)
        scheduler = self.cluster.scheduler
        if (scheduler.cfg.brownout_enabled
                and scheduler.brownout_sheds(spec.priority)):
            self.brownouts += 1
            scale = (1.0 + scheduler.cfg.brownout_eta_growth
                     * scheduler.brownout_level())
            return self._busy(interest, spec, reason_detail="brownout",
                              eta_scale=scale)
        # 6. decentralized work shedding: past the spill threshold, hand
        #    the Interest to a peer cluster through our own forwarder
        if (scheduler.cfg.spill_enabled
                and len(spill_path) < scheduler.cfg.max_spill_hops
                and scheduler.should_spill(spec,
                                           spec.chips(default=1))):
            return self._spill(interest, spec, spill_path, publish)
        # 7. matchmake + admit (the K8s-job spawn)
        try:
            job = self.cluster.submit(spec, now)
        except CapacityError as e:
            # feasible here, just saturated: shed upstream if allowed,
            # else answer with the ETA-carrying busy receipt
            if (scheduler.cfg.spill_enabled
                    and len(spill_path) < scheduler.cfg.max_spill_hops):
                return self._spill(interest, spec, spill_path, publish)
            if self.legacy_nack:
                return self._reject(interest, reasons.no_capacity_reason(e))
            return self._busy(interest, spec)
        except MatchError as e:
            return self._reject(interest, reasons.no_capacity_reason(e))
        if job.state not in (JobState.FAILED, JobState.COMPLETED):
            # a job that already finished synchronously (instant executor
            # or sync failure) must not (re-)enter the dedupe map — the
            # eviction hook fired before we got here
            self._jobs_by_sig[sig] = job.job_id
        return self._receipt(interest, now, state=job.state.value,
                             job_id=job.job_id, spec=spec, job=job)

    def _evict_sig(self, job: Job) -> None:
        sig = job.spec.signature()
        if self._jobs_by_sig.get(sig) == job.job_id:
            del self._jobs_by_sig[sig]

    # --------------------------------------------------------------- batch
    def _on_batch(self, interest: Interest, publish: Callable[[Data], None],
                  now: float):
        """Batched submission: one ``/lidc/jobs/batch/<app>/<k=v&lo=&hi=>``
        Interest admits every ``part=i`` member of a homogeneous task
        range.  Validation, matchmaking and the run estimate are paid
        once for the template; members whose canonical result is already
        in the lake are answered from the §VII cache without touching the
        scheduler; the receipt is one signed Data for the whole range.
        Saturation answers one busy receipt for the range (the client
        re-expresses the batch name elsewhere — no per-member spill)."""
        parsed = batch_fields_of(interest.name)
        if parsed is None:
            return self._reject(interest, reasons.MALFORMED_JOB_NAME)
        fields, lo, hi = parsed
        if hi - lo > MAX_BATCH_MEMBERS:
            return self._reject(
                interest,
                f"{reasons.MALFORMED_JOB_NAME}:range>{MAX_BATCH_MEMBERS}")
        app = fields.pop("app")
        fields.pop(SPILL_FIELD, None)
        avoid = decode_spill_path(fields.pop(AVOID_FIELD, ""))
        template = JobSpec(app=app, fields=dict(fields))
        if self.cluster.name in avoid:
            self.avoided += 1
            return self._busy(interest, template, reason_detail="avoided")
        # retransmit / crash-recovery dedupe: the batch id is a digest of
        # the canonical batch name, so a re-expressed batch lands on its
        # existing record and re-answers the current receipt
        bid = hashlib.sha256(str(interest.name).encode()).hexdigest()[:12]
        rec = self._batches.get(bid)
        if rec is not None:
            return self._batch_receipt(interest, now, rec)
        if not self.cluster.alive:
            return self._reject(interest, reasons.CLUSTER_DOWN)
        # validate ONCE against a sample member — members differ only in
        # part=, which no validator rejects range-dependently
        try:
            self.validators.validate(app, {**fields, "part": str(lo)},
                                     self.cluster.capability_record())
        except ValidationError as e:
            return self._reject(interest, reasons.validation_reason(e))
        lake = self.cluster.lake
        cached: set = set()
        pending: List[tuple] = []
        for part in range(lo, hi):
            mspec = JobSpec(app=app, fields={**fields, "part": str(part)})
            if lake is not None and lake.has(result_name_for(mspec)):
                self.cache_shortcuts += 1
                cached.add(part)
            else:
                pending.append((part, mspec))
        rec = {"bid": bid, "lo": lo, "hi": hi, "cached": cached,
               "done": set(cached), "durs": OrderedDict(), "failed": {},
               "job_ids": {}}
        if not pending:
            self._register_batch(bid, rec)
            return self._batch_receipt(interest, now, rec)

        def register(jobs: List[Job]) -> None:
            # runs before the scheduler dispatches: the member index (and
            # the dedupe map) must exist when a synchronously-finishing
            # member fires the completion hooks
            self._register_batch(bid, rec)
            for (part, _), job in zip(pending, jobs):
                rec["job_ids"][job.job_id] = part
                self._batch_member[job.job_id] = (bid, part)
                self._jobs_by_sig[job.spec.signature()] = job.job_id

        try:
            self.cluster.submit_batch([s for _, s in pending], now,
                                      on_admitted=register)
        except CapacityError:
            if self.legacy_nack:
                return self._reject(interest, reasons.BUSY)
            return self._busy(interest, template)
        except MatchError as e:
            return self._reject(interest, reasons.no_capacity_reason(e))
        return self._batch_receipt(interest, now, rec)

    def _register_batch(self, bid: str, rec: Dict[str, Any]) -> None:
        self._batches[bid] = rec
        while len(self._batches) > MAX_BATCH_RECORDS:
            evict = next((k for k, r in self._batches.items()
                          if k != bid and self._batch_state(r) != "Running"),
                         None)
            if evict is None:
                break       # everything still live: keep the records
            for jid in self._batches[evict]["job_ids"]:
                self._batch_member.pop(jid, None)
            del self._batches[evict]

    def _on_member_done(self, job: Job) -> None:
        entry = self._batch_member.pop(job.job_id, None)
        if entry is None:
            return
        bid, part = entry
        rec = self._batches.get(bid)
        if rec is None:
            return
        if job.state == JobState.COMPLETED:
            rec["done"].add(part)
            if job.duration is not None:
                rec["durs"][part] = job.duration
                while len(rec["durs"]) > MAX_REPORTED_DURS:
                    rec["durs"].popitem(last=False)
        else:
            rec["failed"][part] = job.error or "unknown"

    @staticmethod
    def _batch_state(rec: Dict[str, Any]) -> str:
        total = rec["hi"] - rec["lo"]
        if len(rec["done"]) >= total:
            return "Completed"
        if len(rec["done"]) + len(rec["failed"]) >= total:
            return "Failed"
        return "Running"

    def _batch_receipt(self, interest: Interest, now: float,
                       rec: Dict[str, Any]) -> Data:
        self.receipts_served += 1
        self.batch_receipts += 1
        state = self._batch_state(rec)
        payload = {
            "batch_id": rec["bid"],
            "state": state,
            "cluster": self.cluster.name,
            "lo": rec["lo"], "hi": rec["hi"],
            "admitted": len(rec["job_ids"]),
            "cached": compress_ranges(rec["cached"]),
            "status_name": str(Name.parse(STATUS_PREFIX).append(
                self.cluster.name, "batch", rec["bid"])),
        }
        d = Data.from_json(interest.name, payload, created_at=now,
                           freshness=self._receipt_freshness(state))
        return sign_data(d, self.key, self.cluster.name)

    def _batch_status_payload(self, rec: Dict[str, Any]) -> Dict[str, Any]:
        """One poll answer covers the whole member range: done parts as
        compressed ranges, a bounded window of completed durations (the
        monitor's p50 sample), and the on-chip start time of every member
        currently running (the straggler signal — on-chip age, not queue
        age, is what speculation triggers on)."""
        started = self.cluster.scheduler.running_started()
        running = {}
        for jid, t0 in started.items():
            entry = self._batch_member.get(jid)
            if entry is not None and entry[0] == rec["bid"]:
                running[str(entry[1])] = round(t0, 9)
        return {
            "batch_id": rec["bid"],
            "state": self._batch_state(rec),
            "cluster": self.cluster.name,
            "lo": rec["lo"], "hi": rec["hi"],
            "done_ranges": compress_ranges(rec["done"]),
            "failed": {str(p): e for p, e in rec["failed"].items()},
            "durs": {str(p): round(d, 9) for p, d in rec["durs"].items()},
            "running": running,
        }

    # --------------------------------------------------------------- spill
    def _spill(self, interest: Interest, spec: JobSpec,
               spill_path: List[str], publish: Callable) -> None:
        """Re-express the compute Interest upstream with ourselves
        appended to the hop-carried spill path.  ``skip_local`` keeps our
        own forwarder from handing the work straight back to this
        gateway; the peer's receipt is republished under the *original*
        Interest name (same canonical work, the peer's status namespace).
        """
        self.spills += 1
        cfg = self.cluster.scheduler.cfg
        path = list(spill_path) + [self.cluster.name]
        fields = {"app": spec.app, **spec.fields,
                  SPILL_FIELD: encode_spill_path(path)}
        upstream = Interest(name=canonical_job_name(fields),
                            lifetime=cfg.spill_lifetime,
                            must_be_fresh=True, skip_local=True)
        if self._spill_consumer is None:
            self._spill_consumer = Consumer(
                self.cluster.net, self.cluster.node,
                name=f"{self.cluster.name}-spill")

        def on_receipt(d: Data) -> None:
            payload = d.json()
            payload["spilled_via"] = encode_spill_path(path)
            state = payload.get("state", "Pending")
            out = Data.from_json(interest.name, payload,
                                 created_at=self.cluster.net.now,
                                 freshness=self._receipt_freshness(state))
            publish(sign_data(out, self.key, self.cluster.name))

        def on_fail(reason: str) -> None:
            # every peer declined (or the path timed out): take the job
            # after all if the queue can hold it, else answer busy
            self.spill_failures += 1
            now = self.cluster.net.now
            if self.cluster.alive:
                try:
                    job = self.cluster.submit(spec, now)
                except MatchError:
                    job = None
                if job is not None:
                    if job.state not in (JobState.FAILED,
                                         JobState.COMPLETED):
                        # same terminal-state guard as the sync admit
                        # path: the eviction hook already fired for a
                        # synchronously-finished job
                        self._jobs_by_sig[spec.signature()] = job.job_id
                    publish(self._receipt(interest, now,
                                          state=job.state.value,
                                          job_id=job.job_id, spec=spec,
                                          job=job))
                    return
            publish(self._busy(interest, spec,
                               reason_detail=f"spill-failed:{reason}"))

        self._spill_consumer.express(upstream, on_data=on_receipt,
                                     on_fail=on_fail,
                                     retries=SPILL_RETRY.max_retries)
        return None  # receipt (or busy) is published asynchronously

    # ------------------------------------------------------------- status
    def _on_status(self, interest: Interest, publish: Callable[[Data], None],
                   now: float):
        """The status namespace, routed by prefix to the owning cluster:

        * ``/lidc/status/<cluster>/<job_id>`` — the paper's four-state
          single-job answer (unchanged).
        * ``/lidc/status/<cluster>/ids=<a,b,...>`` — one answer for many
          jobs; the queued-ETA simulation runs once for the whole set.
        * ``/lidc/status/<cluster>/batch/<bid>`` (or ``batch/ids=...``) —
          batched-submission progress as compressed done ranges.
        """
        comps = interest.name.components
        base = Name.parse(STATUS_PREFIX)
        if len(comps) < len(base) + 2:
            return self._reject(interest, reasons.STATUS_NEEDS_JOB_ID)
        selector = comps[len(base) + 1]
        if selector == "batch":
            return self._batch_status(interest, now)
        if selector.startswith("ids="):
            return self._multi_status(interest, now, selector[4:])
        job_id = selector
        job = self.cluster.jobs.get(job_id)
        if job is None:
            return self._reject(interest, reasons.UNKNOWN_JOB)
        payload = job.status_payload()
        if job.state in (JobState.PENDING, JobState.RUNNING):
            eta = self.cluster.scheduler.eta_of(job_id)
            if eta is not None:
                payload["eta"] = round(eta, 6)
        d = Data.from_json(interest.name, payload,
                           created_at=now, freshness=0.25)
        return sign_data(d, self.key, self.cluster.name)

    def _batch_status(self, interest: Interest, now: float):
        comps = interest.name.components
        base = Name.parse(STATUS_PREFIX)
        if len(comps) < len(base) + 3:
            return self._reject(interest, reasons.STATUS_NEEDS_JOB_ID)
        ref = comps[len(base) + 2]
        if ref.startswith("ids="):
            ids = [b for b in ref[4:].split(",") if b][:MAX_STATUS_IDS]
            out = {}
            for b in ids:
                rec = self._batches.get(b)
                out[b] = (self._batch_status_payload(rec)
                          if rec is not None
                          else {"batch_id": b, "state": "Unknown"})
            d = Data.from_json(interest.name, {"batches": out},
                               created_at=now, freshness=0.25)
            return sign_data(d, self.key, self.cluster.name)
        rec = self._batches.get(ref)
        if rec is None:
            return self._reject(interest, reasons.UNKNOWN_JOB)
        payload = self._batch_status_payload(rec)
        fresh = 30.0 if payload["state"] in ("Completed", "Failed") else 0.25
        d = Data.from_json(interest.name, payload,
                           created_at=now, freshness=fresh)
        return sign_data(d, self.key, self.cluster.name)

    def _multi_status(self, interest: Interest, now: float, raw_ids: str):
        """Coalesced per-cluster polling: one Interest, one signed answer
        for up to MAX_STATUS_IDS jobs.  Queued ETAs come from ONE chip-
        timeline replay shared across the whole answer (running jobs use
        the O(1) expected-release path) — this is where the workflow
        engine's poll coalescing stops paying O(stages) simulations."""
        ids = [j for j in raw_ids.split(",") if j][:MAX_STATUS_IDS]
        if not ids:
            return self._reject(interest, reasons.STATUS_NEEDS_JOB_ID)
        scheduler = self.cluster.scheduler
        queued_etas: Optional[Dict[str, float]] = None
        out = {}
        for jid in ids:
            job = self.cluster.jobs.get(jid)
            if job is None:
                out[jid] = {"job_id": jid, "state": "Unknown"}
                continue
            payload = job.status_payload()
            if job.state == JobState.RUNNING:
                eta = scheduler.eta_of(jid)
                if eta is not None:
                    payload["eta"] = round(eta, 6)
            elif job.state == JobState.PENDING:
                if queued_etas is None:
                    queued_etas = scheduler.queued_etas()
                eta = queued_etas.get(jid)
                if eta is not None:
                    payload["eta"] = round(eta, 6)
            out[jid] = payload
        d = Data.from_json(interest.name, {"jobs": out},
                           created_at=now, freshness=0.25)
        return sign_data(d, self.key, self.cluster.name)

    # ------------------------------------------------------------- helpers
    def _receipt(self, interest: Interest, now: float, *, state: str,
                 job_id: str, spec: JobSpec,
                 job: Optional[Job] = None) -> Data:
        self.receipts_served += 1
        payload = {
            "job_id": job_id,
            "state": state,
            "cluster": self.cluster.name,
            "status_name": str(Name.parse(STATUS_PREFIX).append(
                self.cluster.name, job_id)),
            "result_name": str(result_name_for(spec)),
        }
        if job is not None and state in ("Pending", "Running"):
            eta = self.cluster.scheduler.eta_of(job.job_id)
            if eta is not None:
                payload["eta"] = round(eta, 6)
        d = Data.from_json(interest.name, payload, created_at=now,
                           freshness=self._receipt_freshness(state))
        return sign_data(d, self.key, self.cluster.name)

    @staticmethod
    def _receipt_freshness(state: str) -> float:
        """Completed receipts are durable cache entries (the §VII result
        cache); Pending/Running receipts go stale fast so a retransmitted
        Interest after a cluster failure is NOT satisfied by a stale
        pointer to a dead cluster's job.  One rule for local *and*
        spill-republished receipts."""
        return 300.0 if state == "Completed" else 1.0

    def _busy(self, interest: Interest, spec: JobSpec,
              reason_detail: Optional[str] = None,
              eta_scale: float = 1.0) -> Nack:
        """The busy receipt: a structured Nack quoting this cluster's
        predicted completion time and live load, so upstream strategies
        rank us by transfer cost + predicted completion.  ``eta_scale``
        stretches the quoted ETA — brownout uses it to push shed classes
        progressively further away as overload deepens."""
        self.busy_receipts += 1
        self.rejections[reasons.BUSY] = self.rejections.get(reasons.BUSY, 0) + 1
        scheduler = self.cluster.scheduler
        reason = reasons.BUSY if reason_detail is None \
            else f"{reasons.BUSY}:{reason_detail}"
        return Nack(interest, reason, info={
            "eta": round(scheduler.eta(spec) * eta_scale, 6),
            "free_chips": self.cluster.free_chips,
            "queue_depth": scheduler.queue_depth,
        })

    def _reject(self, interest: Interest, reason: str) -> Nack:
        kind = reasons.kind_of(reason)
        self.rejections[kind] = self.rejections.get(kind, 0) + 1
        return Nack(interest, reason)
