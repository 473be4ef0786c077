"""Demand-driven replication: proactively place hot named data toward demand.

The paper's location-independence argument holds for *compute* (any
cluster answering a canonical job name) but, before this plane, data
replicas existed only where a producer put them or where a Content Store
happened to cache them — every cold read of a zipf-hot dataset funneled
back to one origin cluster over the WAN.  This module is the DIRAC-style
answer: a **per-cluster, decentralized**
:class:`ReplicationManager` that turns telemetry the forwarder already
collects into proactive placement.  There is no global controller and no
replica protocol: managers decide alone and coordinate only through the
data plane itself (PIT aggregation dedupes racing pulls; content naming
makes every copy interchangeable).

Pipeline, all on the virtual clock and replay-deterministic:

1. **Observe** — a bounded, decaying :class:`~repro_torch.core.demand.
   DemandTracker` attached to the node's forwarder counts per-object
   Interest demand; the policy also reads the Content Store's per-prefix
   hit rates (demand the cache already absorbs is not worth a replica)
   and ``NextHop.rtt_ewma`` (data that is already near is not worth
   copying).
2. **Decide** — a deterministic hysteresis policy: pull when decayed
   demand crosses ``hot_rate``; never exceed ``budget_bytes`` of managed
   storage or ``max_concurrent`` transfers; negative-cache unfetchable
   names; evict the coldest replicas first when admission needs room,
   never one that is currently hot.
3. **Transfer** — an ordinary :class:`~repro_torch.datalake.fetch.
   SegmentFetcher` (AIMD window, HMAC verification per segment).  Every
   verified segment is persisted into the manager's local store
   immediately, so a transfer that dies mid-flight — cluster crash,
   partition, link flap — **resumes from the segments it already holds**.
   Failures land in a durable retry queue drained by the manager's tick
   with deterministic exponential backoff: RequestManagementSystem-style,
   the queue survives the crash because it lives on the virtual clock,
   not in the transfer.
4. **Serve + advertise** — an installed replica is *served*, not just
   cached: the manager registers a local producer for the object name
   and originates the name through the routing agent's capability gossip
   (``caps={"replica": ...}`` ranks as pure hop cost), so FIBs converge
   on the new copy and :class:`~repro_torch.core.strategy.AdaptiveStrategy`
   steers readers — and splits segment windows — toward the nearest
   replicas.
5. **Account** — ``stats()`` parity with CS/PIT: replica count, bytes
   used vs. budget (``max_bytes_used`` proves the budget was *never*
   exceeded), transfer/retry/eviction counters, demand-tracker bounds.

Arm one manager per cluster on the cluster's gateway node.  When the
node sits in an :class:`~repro_torch.core.overlay.Overlay` whose cluster
re-advertisement rewrites agent origins, give the manager its own agent
or an edge-style agent whose origin set it owns.

The port's copy of ``repro/datalake/replication.py``: the same logic, its imports
pointing inside ``repro_torch``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from ..core import reasons
from ..core.demand import DemandTracker
from ..core.forwarder import Forwarder, Nack, Network
from ..core.names import Name
from ..core.packets import Data, Interest, sign_data
from ..core.routing import RoutingAgent
from .fetch import SegmentFetcher
from .lake import DataLake
from .store import MemoryStore

__all__ = ["ReplicationPolicy", "ReplicationManager", "DemandTracker"]

Key = Tuple[str, ...]


@dataclass
class ReplicationPolicy:
    """Deterministic hysteresis policy knobs (no RNG anywhere)."""

    hot_rate: float = 3.0        # decayed demand that triggers a pull
    cold_rate: float = 0.25      # at/below: replica is eviction-eligible
    cooldown: float = 1.0        # min replica age before eviction
    interval: float = 0.25       # tick cadence (daemon, virtual clock)
    budget_bytes: int = 64 << 20  # managed-storage byte budget (hard)
    max_concurrent: int = 2      # in-flight transfers per manager
    max_retries: int = 8         # retry-queue attempts before giving up
    retry_base: float = 0.25     # deterministic exponential backoff ...
    retry_cap: float = 4.0       # ... capped here
    min_rtt: float = 0.0         # skip pulls when data is nearer than this
    cs_absorb_rate: float = 0.97  # skip pulls the CS already absorbs
    half_life: float = 2.0       # demand decay half-life (seconds)
    demand_capacity: int = 512   # DemandTracker LRU bound
    idle_evict: Optional[float] = None   # drop replicas cold this long
                                 # even without budget pressure (None=keep)
    # namespaces that are never replication candidates: derived or
    # ephemeral objects another plane owns.  Compute results are placed
    # where they were computed and deduped by digest name — a proactive
    # pull can race a stage retry and break exactly-once; serving-session
    # state is live and must-be-fresh — a replica would serve stale
    # tokens.  Both violate gates the chaos soak holds.
    exclude: Tuple[str, ...] = ("/lidc/data/results", "/lidc/data/serve")


@dataclass
class _Replica:
    name: Name
    nbytes: int
    segments: int        # 0 = unsegmented single object
    installed_at: float


class ReplicationManager:
    """One cluster's replication agent — decides, transfers, serves."""

    def __init__(self, net: Network, node: Forwarder, *,
                 agent: Optional[RoutingAgent] = None,
                 policy: Optional[ReplicationPolicy] = None,
                 origin_lake: Optional[DataLake] = None,
                 replica_lake: Optional[DataLake] = None,
                 signer: str = "datalake", key: bytes = b"lidc-lake-key",
                 alive: Optional[Callable[[], bool]] = None,
                 name: Optional[str] = None):
        self.net = net
        self.node = node
        self.agent = agent if agent is not None else node.routing
        self.policy = policy or ReplicationPolicy()
        self.name = name or f"{node.name}-repl"
        # the managed replica store: same signer/key as the origin lake so
        # replica-served Data verifies against the very same trust anchor
        # (the CS admission gate and consumer checks apply unchanged)
        self.local = replica_lake or DataLake(store=MemoryStore(),
                                              signer=signer, key=key)
        self.origin_lake = origin_lake   # never replicate what we originate
        self.alive = alive or (lambda: True)
        self.demand = DemandTracker(capacity=self.policy.demand_capacity,
                                    half_life=self.policy.half_life,
                                    exclude=self.policy.exclude)
        node.demand = self.demand
        self.replicas: Dict[Key, _Replica] = {}
        self._in_flight: Dict[Key, SegmentFetcher] = {}
        self._staged: Dict[Key, Dict[int, int]] = {}   # key -> seg -> bytes
        self._reserved: Dict[Key, int] = {}   # admitted, not yet received
        self._retry: Dict[Key, float] = {}             # key -> not_before
        self._attempts: Dict[Key, int] = {}
        self._negative: Dict[Key, float] = {}          # key -> retry-after
        self.bytes_used = 0
        self.max_bytes_used = 0
        self.transfers_started = 0
        self.transfers_completed = 0
        self.transfers_failed = 0
        self.transfers_deferred = 0    # admission refused (budget-wait)
        self.retries = 0
        self.segments_resumed = 0
        self.evictions = 0
        self.bytes_replicated = 0
        self.bytes_served = 0
        self.serves = 0
        self._started = False
        self._stopped = False

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ReplicationManager":
        """Arm the decision tick (daemon: an idle network still quiesces)."""
        if not self._started:
            self._started = True
            self.net.schedule(self.policy.interval, self._tick, daemon=True)
        return self

    def stop(self) -> None:
        self._stopped = True

    # ----------------------------------------------------------------- tick
    def _tick(self) -> None:
        if self._stopped:
            return
        self.net.schedule(self.policy.interval, self._tick, daemon=True)
        if not self.alive():
            return   # crashed/dark: the retry queue waits on the clock
        now = self.net.now
        self._drain_retries(now)
        self._scan_demand(now)
        if self.policy.idle_evict is not None:
            for key in [k for k, r in self.replicas.items()
                        if now - r.installed_at >= self.policy.idle_evict
                        and self.demand.rate(k, now) <= self.policy.cold_rate]:
                self._evict(key)

    def _drain_retries(self, now: float) -> None:
        for key in [k for k, t in self._retry.items() if t <= now]:
            if len(self._in_flight) >= self.policy.max_concurrent:
                break
            del self._retry[key]
            self._start_transfer(key)

    def _scan_demand(self, now: float) -> None:
        for key, _rate in self.demand.hot(now, self.policy.hot_rate):
            if len(self._in_flight) >= self.policy.max_concurrent:
                break
            if (key in self.replicas or key in self._in_flight
                    or key in self._retry):
                continue
            until = self._negative.get(key)
            if until is not None:
                if now < until:
                    continue
                del self._negative[key]
            name = Name(key)
            if self.origin_lake is not None and self.origin_lake.has(name):
                continue   # we *are* the origin for this object
            if self.local.has(name):
                continue
            if self.node.cs.hit_rate_for(name) >= self.policy.cs_absorb_rate:
                continue   # the cache already absorbs this demand
            if self.policy.min_rtt > 0.0:
                _, hops = self.node.fib.lookup(name)
                rtts = [h.rtt_ewma for h in hops if h.rtt_ewma > 0.0]
                if rtts and min(rtts) < self.policy.min_rtt:
                    continue   # data is already near; a copy buys nothing
            self._start_transfer(key)

    # ------------------------------------------------------------ transfers
    def _start_transfer(self, key: Key) -> None:
        name = Name(key)
        have: Dict[int, bytes] = {}
        base = str(name)
        for i in self._staged.get(key, ()):   # resume from persisted segs
            chunk = self.local.store.get(f"{base}/seg={i}")
            if chunk is not None:
                have[i] = chunk
        fetcher = SegmentFetcher(
            self.net, self.node, name,
            verify_key=self.local.key,
            have=have,
            admit=lambda manifest, k=key: self._admit(k, manifest),
            on_segment=lambda i, d, k=key: self._persist_segment(k, i, d),
            on_complete=lambda blob, k=key: self._install(k, blob),
            on_error=lambda reason, k=key: self._transfer_failed(k, reason))
        # the manager's own pull must not read as fresh reader demand
        self.demand.ignore_faces.add(fetcher.consumer.face.face_id)
        self._in_flight[key] = fetcher
        self.transfers_started += 1
        fetcher.start()

    def _admit(self, key: Key, manifest: Dict) -> bool:
        """Byte-budget admission, knowing the object size from the
        manifest before any segment Interest goes out.  Bytes a
        *concurrent* admitted transfer has yet to receive are reserved,
        so two in-flight pulls cannot jointly overshoot the budget."""
        size = int(manifest["size"])
        staged = sum(self._staged.get(key, {}).values())
        need = size - staged
        if size > self.policy.budget_bytes:
            # can never fit: long negative cache, no retries
            self._negative[key] = self.net.now + 16 * self.policy.cooldown
            return False
        others = sum(v for k, v in self._reserved.items() if k != key)
        want = self.bytes_used + others + need
        if want > self.policy.budget_bytes:
            self._make_room(want - self.policy.budget_bytes, self.net.now,
                            colder_than=self.demand.rate(key, self.net.now))
            want = self.bytes_used + others + need
        if want > self.policy.budget_bytes:
            return False
        self._reserved[key] = need
        return True

    def _persist_segment(self, key: Key, i: int, d: Data) -> None:
        staged = self._staged.setdefault(key, {})
        if i in staged:
            return
        self.local.store.put(f"{Name(key)}/seg={i}", d.content)
        staged[i] = len(d.content)
        if key in self._reserved:
            self._reserved[key] = max(0, self._reserved[key]
                                      - len(d.content))
        self._account(len(d.content))

    def _account(self, delta: int) -> None:
        self.bytes_used += delta
        if self.bytes_used > self.max_bytes_used:
            self.max_bytes_used = self.bytes_used

    def _install(self, key: Key, blob: bytes) -> None:
        fetcher = self._in_flight.pop(key, None)
        self._reserved.pop(key, None)
        if fetcher is not None:
            self.demand.ignore_faces.discard(fetcher.consumer.face.face_id)
        now = self.net.now
        name = Name(key)
        base = str(name)
        manifest = fetcher.manifest if fetcher is not None else None
        if fetcher is not None:
            self.segments_resumed += fetcher.stats.get("resumed", 0)
        if manifest is not None:
            # segments were persisted as they were verified; completing
            # the object is just writing the manifest
            nseg = int(manifest["segments"])
            self.local.store.put(
                f"{base}/manifest",
                json.dumps({"segments": nseg, "size": len(blob),
                            "segment_size": int(manifest.get(
                                "segment_size", len(blob)))}).encode())
        else:
            # unsegmented fallback: size was unknown until now, so the
            # budget check happens at install
            nseg = 0
            need = len(blob)
            others = sum(self._reserved.values())
            if self.bytes_used + others + need > self.policy.budget_bytes:
                self._make_room(self.bytes_used + others + need
                                - self.policy.budget_bytes, now,
                                colder_than=self.demand.rate(key, now))
            if (self.bytes_used + sum(self._reserved.values()) + need
                    > self.policy.budget_bytes):
                self.transfers_deferred += 1
                self._queue_retry(key, now)
                return
            self.local.store.put(base, blob)
            self._account(need)
        self._staged.pop(key, None)
        self._attempts.pop(key, None)
        self.replicas[key] = _Replica(name=name, nbytes=len(blob),
                                      segments=nseg, installed_at=now)
        self.transfers_completed += 1
        self.bytes_replicated += len(blob)
        # served, not just cached: local producer + routed advertisement
        self.node.attach_producer(name, self._serve)
        if self.agent is not None:
            self.agent.originate(name, caps={"replica": self.name})

    def _transfer_failed(self, key: Key, reason: str) -> None:
        fetcher = self._in_flight.pop(key, None)
        self._reserved.pop(key, None)
        if fetcher is not None:
            self.demand.ignore_faces.discard(fetcher.consumer.face.face_id)
        now = self.net.now
        if reason == "admission-refused":
            if key in self._negative:
                return        # oversized for the budget: dropped for good
            self.transfers_deferred += 1
            # room may decay free later; poll at cooldown cadence, not at
            # the transfer-retry cadence — this is contention, not failure
            self._retry[key] = now + 4 * self.policy.cooldown
            return
        if "data-not-found" in reason:
            # authoritative miss (or a demand key that is not a fetchable
            # object): negative-cache, don't burn retries
            self._drop_staged(key)
            self._negative[key] = now + 8 * self.policy.cooldown
            self.transfers_failed += 1
            return
        attempts = self._attempts.get(key, 0) + 1
        self._attempts[key] = attempts
        if attempts > self.policy.max_retries:
            self._attempts.pop(key, None)
            self._drop_staged(key)
            self._negative[key] = now + 8 * self.policy.cooldown
            self.transfers_failed += 1
            return
        self.retries += 1
        self._queue_retry(key, now, attempts)

    def _queue_retry(self, key: Key, now: float, attempts: int = 1) -> None:
        backoff = min(self.policy.retry_base * (2 ** (attempts - 1)),
                      self.policy.retry_cap)
        self._retry[key] = now + backoff

    # -------------------------------------------------------------- serving
    def _serve(self, interest: Interest, publish, now: float):
        """Producer handler for installed replicas: the same zero-copy
        store-key fast path as :meth:`DataLake.attach`, signed with the
        lake key so downstream CS admission and consumer verification
        hold for replica-served bytes exactly as for origin-served."""
        blob = self.local.store.get(str(interest.name))
        if blob is None:
            blob = self.local.get_bytes(interest.name)   # bare-name oracle
            if blob is None:
                return Nack(interest, reasons.DATA_NOT_FOUND)
        self.serves += 1
        self.bytes_served += len(blob)
        d = Data(name=interest.name, content=blob, created_at=now,
                 freshness=30.0)
        return sign_data(d, self.local.key, self.local.signer)

    # ------------------------------------------------------------- eviction
    def _make_room(self, need: int, now: float,
                   colder_than: Optional[float] = None) -> int:
        """Evict the coldest eligible replicas until ``need`` bytes are
        freed (deterministic order: coldest, then oldest, then name).
        Currently-hot replicas and replicas younger than ``cooldown``
        are never evicted, and when ``colder_than`` gives the incoming
        object's demand, only *strictly colder* replicas yield — two
        near-equal objects never thrash each other in and out of the
        budget (the hysteresis half of the policy)."""
        cands = sorted(
            (self.demand.rate(k, now), r.installed_at, k)
            for k, r in self.replicas.items()
            if now - r.installed_at >= self.policy.cooldown)
        freed = 0
        for rate, _, key in cands:
            if freed >= need:
                break
            if rate >= self.policy.hot_rate:
                continue
            if colder_than is not None and rate >= colder_than:
                break   # sorted ascending: nothing colder remains
            freed += self._evict(key)
        return freed

    def _evict(self, key: Key) -> int:
        rep = self.replicas.pop(key)
        base = str(rep.name)
        store = self.local.store
        if rep.segments:
            for i in range(rep.segments):
                store.delete(f"{base}/seg={i}")
            store.delete(f"{base}/manifest")
        else:
            store.delete(base)
        self.bytes_used -= rep.nbytes
        self.node.detach_producer(rep.name)
        if self.agent is not None:
            self.agent.withdraw(rep.name)
        self.evictions += 1
        return rep.nbytes

    def _drop_staged(self, key: Key) -> None:
        staged = self._staged.pop(key, None)
        if not staged:
            return
        base = str(Name(key))
        for i, nbytes in staged.items():
            self.local.store.delete(f"{base}/seg={i}")
            self.bytes_used -= nbytes

    # ------------------------------------------------------------ observers
    def audit(self, oracle: DataLake) -> List[str]:
        """Names of managed replicas whose bytes do NOT match the oracle
        lake — the chaos-soak gate that managed replicas never serve
        stale or corrupt bytes.  Empty list = clean."""
        bad: List[str] = []
        for rep in self.replicas.values():
            mine = self.local.get_bytes(rep.name)
            theirs = oracle.get_bytes(rep.name)
            if (mine is None or theirs is None
                    or bytes(mine) != bytes(theirs)):
                bad.append(str(rep.name))
        return bad

    def stats(self) -> Dict[str, float]:
        """Storage-usage + transfer accounting, `stats()` parity with the
        CS/PIT tables."""
        d = self.demand.stats()
        return {"replicas": len(self.replicas),
                "bytes_used": self.bytes_used,
                "max_bytes_used": self.max_bytes_used,
                "budget_bytes": self.policy.budget_bytes,
                "in_flight": len(self._in_flight),
                "retry_queue": len(self._retry),
                "transfers_started": self.transfers_started,
                "transfers_completed": self.transfers_completed,
                "transfers_failed": self.transfers_failed,
                "transfers_deferred": self.transfers_deferred,
                "retries": self.retries,
                "segments_resumed": self.segments_resumed,
                "evictions": self.evictions,
                "bytes_replicated": self.bytes_replicated,
                "bytes_served": self.bytes_served,
                "serves": self.serves,
                "demand_entries": d["entries"],
                "demand_evictions": d["evictions"]}
