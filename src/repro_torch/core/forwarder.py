"""The NDN forwarding plane: faces, forwarders, and a virtual-clock network.

The paper's deployment runs NFD forwarders over real links; this container
has one host, so the plane is an **in-process discrete-event simulation**
with deterministic virtual time.  Everything observable about the paper's
mechanism — LPM forwarding, PIT aggregation, duplicate-nonce suppression,
Content-Store hits, NACK-driven failover, interest-lifetime retransmission —
behaves identically; only the transport differs (see DESIGN.md §8).

Bulk-data semantics layered on top of that pipeline:

* Faces optionally model **link bandwidth** (store-and-forward FIFO
  serialization per packet), which is what makes windowed segment
  transfer measurably faster than monolithic Data on the virtual clock.
* The Content Store is **byte-budgeted** (``cs_capacity_bytes``) so bulk
  segments compete for bytes rather than evicting thousands of small
  cached results one LRU slot at a time.
* PIT expiry is driven from *every* packet arrival and from a scheduled
  tick at the earliest entry deadline — a quiescent forwarder still
  reports timeouts to its strategy (loss feedback never starves).
* ``Consumer.express`` accepts a per-Interest ``rto``, the hook the
  windowed :class:`~repro.datalake.fetch.SegmentFetcher` uses to run its
  own AIMD retransmission instead of the default lifetime-based retry.

Topology model::

    consumer app ──face── Forwarder ──face── Forwarder ──face── producer app
                           (client)            (gateway node of a cluster)

Producers attach to a node by registering a prefix with a handler.  The
handler may answer immediately (Data / Nack) or asynchronously by calling
``publish`` later (long-running compute jobs).

The port's copy of ``repro/core/forwarder.py``: the same logic, its imports
pointing inside ``repro_torch``.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import reasons
from .names import Name
from .packets import Data, Interest, verify_trusted
from .resilience import NOROUTE_FAST_RETRY, CONSUMER_EXPRESS, RetryBudget, \
    RetryPolicy
from .tables import ContentStore, Fib, Pit

__all__ = ["Nack", "Network", "Face", "Forwarder", "Consumer", "wire_size",
           "CONTROL_PREFIX", "link"]


@dataclass(frozen=True)
class Nack:
    """Negative acknowledgement (no route / rejected / no capacity).

    ``info`` carries optional structured detail — a *busy receipt* from a
    saturated gateway puts its predicted completion time (``eta``) and
    live load here, which the forwarder feeds into per-nexthop ETA
    estimates so strategies can rank clusters by transfer cost plus
    predicted completion instead of hop cost alone.
    """

    interest: Interest
    reason: str
    info: Optional[Dict[str, Any]] = field(default=None, compare=False)

    @property
    def name(self) -> Name:
        return self.interest.name


# ---------------------------------------------------------------------------
# Virtual-clock event network
# ---------------------------------------------------------------------------

# sentinel: "no argument" for Network.schedule — lets hot callers pass the
# callback argument through the event tuple instead of closing over it in a
# fresh lambda per packet
_NO_ARG = object()

# event tuples are (time, seq, daemon, fn, arg); seq is unique per network,
# so comparisons never reach fn/arg and global (time, seq) order is total —
# both engines below pop in exactly this order, which is what the seeded
# equivalence tests pin down.
_Event = Tuple[float, int, bool, Callable[..., None], Any]


class _HeapQueue:
    """The original engine: one global binary heap of events."""

    __slots__ = ("_heap",)

    def __init__(self) -> None:
        self._heap: List[_Event] = []

    def push(self, ev: _Event) -> None:
        heapq.heappush(self._heap, ev)

    def peek(self) -> Optional[_Event]:
        return self._heap[0] if self._heap else None

    def pop(self) -> _Event:
        return heapq.heappop(self._heap)

    def __len__(self) -> int:
        return len(self._heap)


class _CalendarQueue:
    """Bucketed (calendar-queue) event scheduler.

    The simulator's event mix is bimodal: dense sub-millisecond data-plane
    events (packet deliveries, batch flushes) plus sparse far-future
    control-plane timers (heartbeats seconds out, PIT/route expiries).  A
    single global heap pays O(log n) per operation with n inflated by all
    the far-future timers; the calendar queue keys each event into a
    fixed-width time bucket (a plain dict of append-only lists), keeps a
    small heap of occupied bucket indices, and heapifies only the
    *current* bucket as it comes up — so ordering work is confined to the
    handful of events that share the active time window, and a far-future
    timer costs one dict append until its bucket's turn.

    Ordering is identical to the heap engine: buckets are drained in index
    order and each bucket is a min-heap over the full (time, seq) event
    tuple, so pops come out in global (time, seq) order.  A push whose
    bucket index is at or before the current bucket's (possible when a
    ``run(until=...)`` horizon parked the clock short of the head event)
    goes straight into the current heap — events are never scheduled in
    the past, so it belongs in the active window.
    """

    __slots__ = ("width", "_buckets", "_occupied", "_cur", "_cur_idx",
                 "_len")

    def __init__(self, width: float = 0.005) -> None:
        self.width = width
        self._buckets: Dict[int, List[_Event]] = {}
        self._occupied: List[int] = []      # min-heap of future bucket indices
        self._cur: List[_Event] = []        # current bucket, a min-heap
        self._cur_idx = -1
        self._len = 0

    def push(self, ev: _Event) -> None:
        self._len += 1
        idx = int(ev[0] / self.width)
        if idx <= self._cur_idx:
            heapq.heappush(self._cur, ev)
            return
        bucket = self._buckets.get(idx)
        if bucket is None:
            self._buckets[idx] = [ev]
            heapq.heappush(self._occupied, idx)
        else:
            bucket.append(ev)

    def _advance(self) -> None:
        """Move to the next occupied bucket; heapified once on entry."""
        while self._occupied:
            idx = heapq.heappop(self._occupied)
            bucket = self._buckets.pop(idx)
            if bucket:
                heapq.heapify(bucket)
                self._cur = bucket
                self._cur_idx = idx
                return
        self._cur = []
        self._cur_idx = -1

    def peek(self) -> Optional[_Event]:
        if not self._cur:
            if not self._occupied:
                return None
            self._advance()
            if not self._cur:
                return None
        return self._cur[0]

    def pop(self) -> _Event:
        if not self._cur and self.peek() is None:
            raise IndexError("pop from empty calendar queue")
        self._len -= 1
        ev = heapq.heappop(self._cur)
        if not self._cur and not self._occupied:
            self._cur_idx = -1   # fully drained: reset the active window
        return ev

    def __len__(self) -> int:
        return self._len


class Network:
    """Deterministic discrete-event scheduler shared by all nodes.

    Events come in two flavors.  *Live* events are application work
    (Interests, Data, timers a consumer is waiting on).  *Daemon* events
    are the control plane's heartbeat — routing hellos, advertisement
    batches, refresh floods — which would tick forever and must therefore
    never keep :meth:`run` from quiescing.  ``run()`` stops when only
    daemon events remain; ``run(until=T)`` drives the clock through
    daemon events up to T, which is how tests and benchmarks let the
    routing protocol converge while the data plane is otherwise idle.

    ``engine`` selects the event queue: ``"calendar"`` (default) is the
    bucketed scheduler tuned for the bimodal event mix, ``"heap"`` is the
    original global binary heap.  Both pop events in identical (time, seq)
    order — seeded scenarios produce bit-identical traces on either
    (tests/test_engine.py proves it), so the choice is purely about speed.

    Setting ``trace`` to a list makes :meth:`run` append one ``(time,
    seq)`` pair per executed event — the hook the equivalence tests and
    ``benchmarks/engine_speed.py`` use to prove identical event order.
    """

    def __init__(self, engine: str = "calendar",
                 bucket_width: float = 0.005) -> None:
        if engine == "calendar":
            self._queue = _CalendarQueue(width=bucket_width)
        elif engine == "heap":
            self._queue = _HeapQueue()
        else:
            raise ValueError(f"unknown engine {engine!r}; "
                             "want 'calendar' or 'heap'")
        self.engine = engine
        self._seq = itertools.count()
        self._live = 0
        self.now = 0.0
        self.events_processed = 0
        self.trace: Optional[List[Tuple[float, int]]] = None

    def schedule(self, delay: float, fn: Callable[..., None],
                 daemon: bool = False, arg: Any = _NO_ARG) -> None:
        """Schedule ``fn`` after ``delay``; with ``arg``, the event calls
        ``fn(arg)`` — hot paths use this to avoid a closure per packet."""
        if not daemon:
            self._live += 1
        t = self.now + delay if delay > 0.0 else self.now
        self._queue.push((t, next(self._seq), daemon, fn, arg))

    def run(self, until: Optional[float] = None, max_events: int = 1_000_000) -> None:
        """Process events in time order until quiescence (or `until`).

        Quiescence means *no live events remain* — daemon events (routing
        heartbeats) alone do not keep the run alive, but they do execute,
        in time order, for as long as live events or the ``until`` horizon
        pull the clock forward.  With ``until``, the clock always ends at
        the horizon so back-to-back windowed runs make steady progress.
        """
        queue = self._queue
        trace = self.trace
        n = 0
        while n < max_events:
            head = queue.peek()
            if head is None:
                break
            t = head[0]
            if until is not None and t > until:
                break
            if until is None and self._live == 0:
                break
            queue.pop()
            if not head[2]:
                self._live -= 1
            if t > self.now:
                self.now = t
            if trace is not None:
                trace.append((t, head[1]))
            fn, arg = head[3], head[4]
            if arg is _NO_ARG:
                fn()
            else:
                fn(arg)
            n += 1
        self.events_processed += n
        if until is not None:
            head = queue.peek()
            if head is None or head[0] > until:
                # advance to the horizon only when every event inside it
                # ran — a max_events exhaustion must not warp queued
                # events' clocks
                if until > self.now:
                    self.now = until

    def idle(self) -> bool:
        return self._live == 0


# ---------------------------------------------------------------------------
# Faces
# ---------------------------------------------------------------------------

_WIRE_HEADER = 48   # nominal per-packet header bytes for the wire model


def wire_size(packet: Any) -> int:
    """Approximate on-the-wire size: header + name + (Data) content.

    Cached on the packet (name and content are immutable, so the size
    can't change); a multi-hop path otherwise re-stringifies the name at
    every bandwidth-modelled face it crosses.
    """
    size = getattr(packet, "_wire", None)
    if size is not None:
        return size
    size = _WIRE_HEADER + len(str(packet.name))
    content = getattr(packet, "content", None)
    if content is not None:
        size += len(content)
    try:
        object.__setattr__(packet, "_wire", size)
    except AttributeError:
        pass  # __slots__-style packets: just recompute next time
    return size


@dataclass
class Face:
    """A unidirectionally-addressed attachment point on a forwarder.

    ``deliver`` sends a packet *out* of this face toward the peer; the
    network schedules arrival after ``latency`` seconds.  Faces can be
    taken ``down`` to model link/cluster failure (paper: clusters leaving
    the overlay).  ``loss``/``jitter`` are the fault-injection hooks
    (workflow/faults.py): per-packet drop probability drawn from an
    injector-owned seeded RNG, and extra per-packet latency — both
    deterministic on the virtual clock.

    ``bandwidth`` (bytes/sec, None = unconstrained) turns the face into a
    store-and-forward FIFO link: each packet occupies the wire for
    ``wire_size/bandwidth`` seconds and queues behind earlier packets.
    This is what makes *bulk data* throughput observable on the virtual
    clock — a 64 MiB monolithic Data serializes for seconds while 1 MiB
    segments pipeline hop-by-hop and across replicas.
    """

    face_id: int
    latency: float = 0.001
    down: bool = False
    # fault injection (set by repro.workflow.faults.FaultInjector)
    loss: float = 0.0
    jitter: float = 0.0
    drops: int = 0
    loss_rng: Optional[Any] = None     # random.Random owned by the injector
    # gray faults (same injector-owned RNG discipline as loss_rng): per-
    # packet payload byte-flip probability (Data only — the HMAC must
    # catch it), duplicate-delivery probability, and reorder probability
    # (an extra hold-back of ``reorder_delay`` seconds, enough to land a
    # packet behind its successors)
    corrupt: float = 0.0
    duplicate: float = 0.0
    reorder: float = 0.0
    reorder_delay: float = 0.005
    fault_rng: Optional[Any] = None
    corruptions: int = 0
    duplicates: int = 0
    reorders: int = 0
    # link capacity model (benchmarks/data_plane.py sets this)
    bandwidth: Optional[float] = None  # bytes/sec; None = zero-width packets
    _busy_until: float = 0.0           # FIFO serialization horizon
    # packet counters for benchmarks
    tx_interests: int = 0
    tx_data: int = 0
    tx_nacks: int = 0
    tx_data_bytes: int = 0
    _peer_recv: Optional[Callable[[Any], None]] = None
    _net: Optional[Network] = None

    def connect(self, net: Network, peer_recv: Callable[[Any], None]) -> None:
        self._net = net
        self._peer_recv = peer_recv

    def send(self, packet: Any, daemon: bool = False) -> None:
        """``daemon=True`` marks the delivery event as control-plane
        traffic (routing adverts/hellos) that must not block network
        quiescence; the wire model (loss, bandwidth, latency) applies to
        it all the same — the protocol really is in-band."""
        if self.down or self._peer_recv is None or self._net is None:
            return  # packets into a dead face vanish — exactly like the wire
        if (self.loss > 0.0 and self.loss_rng is not None
                and self.loss_rng.random() < self.loss):
            self.drops += 1
            return  # injected loss: the packet vanishes on the wire
        # gray faults: each draw happens only when that fault is armed, so
        # fault-free runs consume zero RNG and traces stay unchanged.  The
        # draw order (corrupt -> duplicate -> reorder) is fixed — part of
        # the replay-determinism contract.
        duplicate = False
        reorder_extra = 0.0
        rng = self.fault_rng
        if rng is not None:
            if (self.corrupt > 0.0 and isinstance(packet, Data)
                    and len(packet.content) > 0
                    and rng.random() < self.corrupt):
                packet = _flip_byte(packet, rng)
                self.corruptions += 1
            if self.duplicate > 0.0 and rng.random() < self.duplicate:
                duplicate = True
                self.duplicates += 1
            if self.reorder > 0.0 and rng.random() < self.reorder:
                reorder_extra = self.reorder_delay
                self.reorders += 1
        if isinstance(packet, Interest):
            self.tx_interests += 1
        elif isinstance(packet, Data):
            self.tx_data += 1
            self.tx_data_bytes += len(packet.content)
        elif isinstance(packet, Nack):
            self.tx_nacks += 1
        delay = self.latency + self.jitter
        if self.bandwidth:
            now = self._net.now
            start = max(now, self._busy_until)
            self._busy_until = start + wire_size(packet) / self.bandwidth
            delay = (self._busy_until - now) + self.latency + self.jitter
        delay += reorder_extra
        # arg-based delivery: no per-packet closure allocation
        self._net.schedule(delay, self._peer_recv, daemon=daemon, arg=packet)
        if duplicate:
            # the twin rides one reorder-window behind the original —
            # deterministic, and late enough to exercise dedup paths
            self._net.schedule(delay + self.reorder_delay, self._peer_recv,
                               daemon=daemon, arg=packet)


def _flip_byte(data: Data, rng: Any) -> Data:
    """Corrupt one payload byte; a fresh clone so CS copies elsewhere (and
    the producer's own object) keep the true bytes."""
    clone = object.__new__(Data)
    clone.__dict__.update(data.__dict__)
    raw = bytearray(bytes(data.content))
    raw[rng.randrange(len(raw))] ^= rng.randrange(1, 256)
    clone.__dict__["content"] = bytes(raw)
    clone.__dict__.pop("_wire", None)    # stale caches must not survive
    clone.__dict__.pop("_sigok", None)
    return clone


def link(net: Network, a: "Forwarder", b: "Forwarder", latency: float = 0.001
         ) -> Tuple[Face, Face]:
    """Create a bidirectional link between two forwarders."""
    fa = a.add_face(latency=latency)
    fb = b.add_face(latency=latency)
    fa.connect(net, lambda pkt, f=fb: b.receive(f.face_id, pkt))
    fb.connect(net, lambda pkt, f=fa: a.receive(f.face_id, pkt))
    return fa, fb


# ---------------------------------------------------------------------------
# Forwarder
# ---------------------------------------------------------------------------

ProducerHandler = Callable[[Interest, Callable[[Data], None], float], Optional[Any]]

# control-plane namespace: Interests under this prefix are routing-protocol
# messages, dispatched to the node's RoutingAgent before CS/PIT/FIB
CONTROL_PREFIX = ("lidc", "rt")


class Forwarder:
    """One NDN node: FIB + PIT + CS + strategy, with attached producer apps.

    ``routing`` is the node's optional :class:`~repro_torch.core.routing.
    RoutingAgent`: Interests under ``/lidc/rt/`` are handed to it directly
    (hop-by-hop control traffic, never forwarded), and a failed face is
    reported to it so link death feeds triggered routing updates.
    """

    def __init__(self, net: Network, name: str, strategy=None,
                 cs_capacity: int = 4096,
                 cs_capacity_bytes: Optional[int] = None):
        from .strategy import BestRouteStrategy  # local import to avoid cycle
        self.net = net
        self.name = name
        self.fib = Fib()
        self.pit = Pit()
        self.cs = ContentStore(capacity=cs_capacity,
                               capacity_bytes=cs_capacity_bytes)
        self.strategy = strategy or BestRouteStrategy()
        self.routing = None   # set by RoutingAgent.__init__
        self._pit_tick_at: Optional[float] = None
        self.faces: Dict[int, Face] = {}
        self._next_face = itertools.count(1)
        # local producers: prefix -> handler; _producer_lens caches the
        # distinct registered prefix lengths (descending) so the per-packet
        # LPM probes a couple of dict keys instead of materializing every
        # prefix Name of every Interest
        self._producers: Dict[Tuple[str, ...], ProducerHandler] = {}
        self._producer_lens: List[int] = []
        # optional per-prefix demand telemetry (repro_torch.core.demand.
        # DemandTracker), attached by a replication manager; None keeps
        # the Interest hot path one attribute check away from unchanged
        self.demand = None
        self.stats = {"in_interest": 0, "in_data": 0, "in_nack": 0,
                      "cs_hit": 0, "dropped": 0, "agg": 0, "retx": 0,
                      "cs_poison_rejected": 0}

    # -- wiring -------------------------------------------------------------
    def add_face(self, latency: float = 0.001) -> Face:
        f = Face(face_id=next(self._next_face), latency=latency)
        self.faces[f.face_id] = f
        return f

    def attach_producer(self, prefix: Name, handler: ProducerHandler) -> None:
        """Local application serving a prefix (gateway, data lake, ...)."""
        self._producers[prefix.components] = handler
        n = len(prefix.components)
        if n not in self._producer_lens:
            self._producer_lens.append(n)
            self._producer_lens.sort(reverse=True)

    def detach_producer(self, prefix: Name) -> None:
        """Remove a local producer (e.g. an evicted managed replica)."""
        if self._producers.pop(prefix.components, None) is not None:
            lens = {len(k) for k in self._producers}
            self._producer_lens = sorted(lens, reverse=True)

    def register_route(self, prefix: Name, face: Face, cost: float = 1.0) -> None:
        self.fib.register(prefix, face.face_id, cost)

    def fail_face(self, face: Face) -> None:
        """Link/cluster failure: drop routes and stop delivery."""
        face.down = True
        self.fib.remove_face(face.face_id)
        if self.routing is not None:
            self.routing.on_face_down(face.face_id)

    # -- packet entry point ---------------------------------------------------
    def receive(self, face_id: int, packet: Any) -> None:
        if isinstance(packet, Interest):
            if (self.routing is not None
                    and packet.name.components[:2] == CONTROL_PREFIX):
                # hop-by-hop routing-protocol message: never enters the
                # CS/PIT/FIB pipeline and is never forwarded
                self.routing.handle_control(face_id, packet)
                return
            self._on_interest(face_id, packet)
        elif isinstance(packet, Data):
            self._on_data(face_id, packet)
        elif isinstance(packet, Nack):
            self._on_nack(face_id, packet)

    # -- pit expiry -----------------------------------------------------------
    def _expire_pit(self, now: float) -> None:
        """Expired entries are timeouts: teach the strategy that those
        upstreams went silent (a dark cluster never NACKs).  Driven from
        every packet arrival *and* from a scheduled tick armed at the
        earliest PIT expiry, so a quiescent forwarder still records
        timeout outcomes instead of starving the strategy of loss
        feedback until the next Interest happens by."""
        if not self.pit.expires_by(now):
            return  # O(1) heap-top peek; nothing due — the common case
        for dead in self.pit.expire(now):
            for face_id, sent in dead.sent_at.items():
                if face_id not in dead.resolved:
                    dead.resolved.add(face_id)
                    self._record_outcome(dead.name, face_id, False,
                                         now - sent, now)

    def _arm_pit_tick(self) -> None:
        nxt = self.pit.next_expiry()
        if nxt is None:
            return
        t = nxt + 1e-9
        if self._pit_tick_at is not None and self._pit_tick_at <= t:
            return  # an earlier (or same) tick is already scheduled
        self._pit_tick_at = t
        self.net.schedule(max(t - self.net.now, 0.0), self._pit_tick)

    def _pit_tick(self) -> None:
        self._pit_tick_at = None
        self._expire_pit(self.net.now)
        self._arm_pit_tick()

    # -- interest pipeline ----------------------------------------------------
    def _on_interest(self, in_face: int, interest: Interest) -> None:
        now = self.net.now
        self.stats["in_interest"] += 1
        if self.demand is not None:
            self.demand.observe(interest.name, now, in_face)
        self._expire_pit(now)
        if interest.hop_limit <= 0:
            self.stats["dropped"] += 1
            return
        # 1. Content Store (this is also the paper's §VII result cache)
        cached = self.cs.match(interest, now)
        if cached is not None:
            self.stats["cs_hit"] += 1
            self._send(in_face, cached)
            return
        # 2. Local producer? (longest-prefix over registered producers)
        #    An interest flagged skip_local bypasses this node's own
        #    producers — a saturated gateway spilling work upstream must
        #    not be handed the work right back; forwarding clears the
        #    flag, so the producers of every *other* node still answer.
        if not interest.skip_local and self._producer_lens:
            comps = interest.name.components
            n = len(comps)
            producers = self._producers
            for plen in self._producer_lens:   # descending => longest match
                if plen > n:
                    continue
                handler = producers.get(comps[:plen])
                if handler is not None:
                    self._dispatch_producer(handler, in_face, interest)
                    return
        # 3. PIT insert (aggregation / duplicate suppression / retransmission)
        prior = self.pit.get(interest.name)
        is_retx = (prior is not None and in_face in prior.in_faces
                   and interest.nonce not in prior.nonces)
        entry, is_new, dup = self.pit.insert(interest, in_face, now)
        self._arm_pit_tick()
        if dup:
            self.stats["dropped"] += 1
            return
        if not is_new:
            if is_retx:
                # NFD-style retransmission: the downstream is retrying, so
                # the upstreams we tried are presumed slow/dead — forward
                # to an *untried* upstream instead of silently aggregating
                entry.retransmissions += 1
                self.stats["retx"] += 1
                self._forward(interest, entry, in_face, now,
                              exclude_tried=True)
            else:
                self.stats["agg"] += 1  # aggregated onto existing entry
            return
        # 4. FIB lookup + strategy choice
        self._forward(interest, entry, in_face, now, nack_if_stuck=True)

    def _forward(self, interest: Interest, entry, in_face: int, now: float,
                 exclude_tried: bool = False, nack_if_stuck: bool = False
                 ) -> None:
        _, hops = self.fib.lookup(interest.name)
        eligible = [h for h in hops
                    if h.healthy and not self.faces[h.face_id].down
                    and h.face_id != in_face]
        live = [h for h in eligible
                if not (exclude_tried and h.face_id in entry.out_faces)]
        if not live and exclude_tried:
            # every upstream was already tried: re-forward to the best of
            # them instead of black-holing the retransmission until the
            # PIT entry expires (the presumed-slow upstream may answer the
            # fresh nonce; a windowed fetcher's retries depend on this)
            live = eligible
        if not live:
            if nack_if_stuck:
                self.pit.satisfy(interest.name)
                self._send(in_face, Nack(interest, reasons.NO_ROUTE))
            return
        chosen = self.strategy.choose(interest, entry, live, now)
        fwd = interest.decrement_hop()
        for h in chosen:
            # hold one congestion slot per unresolved attempt on this face:
            # a re-forward while the prior attempt is still outstanding
            # reuses its slot; a re-forward after a recorded outcome opens
            # a new one (and re-arms the verdict via `resolved`)
            if h.face_id not in entry.out_faces or h.face_id in entry.resolved:
                h.pending += 1
            entry.resolved.discard(h.face_id)
            entry.out_faces.add(h.face_id)
            entry.sent_at[h.face_id] = now
            h.last_used = now
            self._send(h.face_id, fwd)

    def _dispatch_producer(self, handler: ProducerHandler, in_face: int,
                           interest: Interest) -> None:
        now = self.net.now
        entry, is_new, dup = self.pit.insert(interest, in_face, now)
        self._arm_pit_tick()
        if dup:
            return
        if not is_new:
            self.stats["agg"] += 1
            return

        def publish(packet: Any) -> None:
            if isinstance(packet, Nack):
                # an async producer (e.g. a gateway whose spill attempt
                # failed) may answer negatively after the fact: resolve
                # the PIT and propagate downstream like a sync Nack
                for e in self.pit.satisfy(interest.name):
                    for down in e.in_faces:
                        if down in self.faces:
                            self._send(down, packet)
                return
            self._on_data(face_id=-1, data=packet)  # as if it arrived locally

        result = handler(interest, publish, now)
        if isinstance(result, Data):
            publish(result)
        elif isinstance(result, Nack):
            self.pit.satisfy(interest.name)
            self._send(in_face, result)
        # None => producer will publish() asynchronously.

    # -- data pipeline ----------------------------------------------------------
    def _on_data(self, face_id: int, data: Data) -> None:
        now = self.net.now
        self.stats["in_data"] += 1
        entries = self.pit.satisfy(data.name)
        if not entries:
            self.stats["dropped"] += 1   # unsolicited data
            return
        # Content-Store admission gate: a signed Data whose HMAC fails
        # verification must never poison the cache (later consumers would
        # be served garbage straight from the CS, past every end-to-end
        # check).  It is still forwarded downstream — consumers verify
        # end-to-end and drive their own retries; the cache just refuses
        # to amplify the corruption.
        if self._cacheable(data):
            self.cs.insert(data)
        else:
            self.stats["cs_poison_rejected"] += 1
        for entry in entries:
            # measurement feedback for strategies (rtt per upstream face)
            if face_id in entry.sent_at and face_id not in entry.resolved:
                entry.resolved.add(face_id)
                sent = entry.sent_at[face_id]
                self._record_outcome(entry.name, face_id, True, now - sent, now)
                # upstreams tried in an *earlier* round that still lost the
                # race were silent/slow-failing — teach the strategy.  Faces
                # from the same round (multicast fanout) just release their
                # outstanding-interest slot, with no verdict either way.
                for f, t in entry.sent_at.items():
                    if f in entry.resolved:
                        continue
                    entry.resolved.add(f)
                    if t < sent:
                        self._record_outcome(entry.name, f, False, now - t, now)
                    else:
                        self._release_pending(entry.name, f)
            # entries satisfied without an outcome (e.g. the Data arrived via
            # a face this entry never tried) still free their slots
            for f in entry.sent_at:
                if f not in entry.resolved:
                    entry.resolved.add(f)
                    self._release_pending(entry.name, f)
            for down in entry.in_faces:
                if down != face_id and down in self.faces:
                    self._send(down, data)
        # data arrival also drives expiry (satisfied names were popped above,
        # so a Data landing exactly at its own deadline still wins the race)
        self._expire_pit(now)

    # -- nack pipeline -------------------------------------------------------------
    def _on_nack(self, face_id: int, nack: Nack) -> None:
        now = self.net.now
        self.stats["in_nack"] += 1
        self._expire_pit(now)
        entry = self.pit.get(nack.name)
        if entry is None:
            return
        # resolve the upstream's outstanding slot; only *transport/capacity*
        # Nacks count as loss.  "data-not-found" is an authoritative answer
        # ("I am healthy and don't have it") — scoring it as path loss would
        # let every small-object manifest probe poison the loss EWMA of
        # perfectly healthy replicas
        if nack.info and "eta" in nack.info:
            # busy receipt: the upstream quoted a predicted completion
            # time — remember it on the nexthop so ETA-aware strategies
            # rank by transfer cost + predicted completion
            hop = self._hop_for(nack.name, face_id)
            if hop is not None:
                hop.record_eta(float(nack.info["eta"]))
        if face_id in entry.sent_at and face_id not in entry.resolved:
            entry.resolved.add(face_id)
            if reasons.is_authoritative(nack.reason):
                self._release_pending(nack.name, face_id)
            else:
                self._record_outcome(nack.name, face_id, False,
                                     now - entry.sent_at[face_id], now)
        _, hops = self.fib.lookup(nack.name)
        untried = [h for h in hops
                   if h.face_id not in entry.out_faces
                   and h.healthy and not self.faces[h.face_id].down]
        if untried:
            chosen = self.strategy.choose(nack.interest, entry, untried, now)
            fwd = nack.interest.decrement_hop()
            for h in chosen:
                entry.out_faces.add(h.face_id)
                entry.sent_at[h.face_id] = now
                h.pending += 1
                h.last_used = now
                self._send(h.face_id, fwd)
            return
        # exhausted: propagate NACK downstream
        for entry in self.pit.satisfy(nack.name):
            for f in entry.sent_at:
                if f not in entry.resolved:
                    entry.resolved.add(f)
                    self._release_pending(entry.name, f)
            for down in entry.in_faces:
                if down in self.faces:
                    self._send(down, nack)

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _cacheable(data: Data) -> bool:
        """Signed Data must verify against its signer's registered key to
        enter the CS; unsigned Data (or an unknown signer) has no verdict
        and stays cacheable.  The verdict is memoized on the packet object
        — one HMAC per Data per network, not per hop."""
        ok = data.__dict__.get("_sigok")
        if ok is None:
            ok = verify_trusted(data) is not False
            object.__setattr__(data, "_sigok", ok)
        return ok

    def _hop_for(self, name: Name, face_id: int):
        matched, _ = self.fib.lookup(name)
        if matched is None:
            return None
        return self.fib.nexthops(matched).get(face_id)

    def _record_outcome(self, name: Name, face_id: int, ok: bool,
                        rtt: float, now: float) -> None:
        """Update per-nexthop moving stats and notify the strategy."""
        hop = self._hop_for(name, face_id)
        if hop is not None:
            hop.record(ok, rtt)
            if hop.pending > 0:
                hop.pending -= 1
        self.strategy.feedback(name, face_id, ok, rtt, now)

    def _release_pending(self, name: Name, face_id: int) -> None:
        """The interest is no longer outstanding on this face (the PIT entry
        resolved elsewhere) — free the congestion slot, no verdict."""
        hop = self._hop_for(name, face_id)
        if hop is not None and hop.pending > 0:
            hop.pending -= 1

    def _send(self, face_id: int, packet: Any) -> None:
        if face_id < 0:
            return
        face = self.faces.get(face_id)
        if face is not None:
            face.send(packet)


# ---------------------------------------------------------------------------
# Consumer
# ---------------------------------------------------------------------------

class Consumer:
    """A client application attached to a forwarder node.

    Implements the retransmission loop that, combined with PIT expiry and
    strategy failover upstream, gives LIDC its resilience: if the chosen
    cluster dies, the retransmitted Interest (fresh nonce) is routed to
    another announcing cluster.
    """

    def __init__(self, net: Network, node: Forwarder, name: str = "consumer",
                 noroute_policy: RetryPolicy = NOROUTE_FAST_RETRY,
                 express_policy: RetryPolicy = CONSUMER_EXPRESS,
                 retry_budget: Optional[RetryBudget] = None):
        self.net = net
        self.node = node
        self.name = name
        self.face = node.add_face(latency=0.0005)
        # name -> in-flight request state; same-name expresses aggregate onto
        # one upstream request (the consumer-side analog of PIT aggregation)
        self._pending: Dict[Tuple[str, ...], Dict[str, Any]] = {}
        self.face.connect(net, self._receive)
        self.nacks: List[Nack] = []
        self.noroute_policy = noroute_policy
        self.express_policy = express_policy
        # optional shared token bucket bounding timeout-retransmit storms
        # per prefix root; None (default) keeps legacy unbounded behavior
        self.retry_budget = retry_budget
        # retry-amplification accounting: interests injected vs. names
        # answered — the soak gates expressed/satisfied <= 3x
        self.expressed = 0
        self.satisfied = 0
        self.hedges = 0

    def express(self, interest: Interest,
                on_data: Callable[[Data], None],
                on_fail: Optional[Callable[[str], None]] = None,
                retries: Optional[int] = None, rto: Optional[float] = None,
                hedge_delay: Optional[float] = None) -> None:
        """Express an Interest; ``rto`` overrides the retransmission timer
        (default: 0.9 × interest lifetime).  Window-based transports (the
        segment fetcher) pass their own adaptive RTO and ``retries=0`` so
        loss surfaces as ``on_fail('timeout')`` instead of blind retries.

        ``hedge_delay`` arms tail-tolerance hedging: if no answer arrived
        after that many seconds, a second Interest (fresh nonce) races the
        first — the live PIT entry routes it to an *untried* upstream and
        dedupes whichever answer loses.  Hedges consume no ``retries``.
        """
        if retries is None:
            retries = self.express_policy.max_retries
        key = interest.name.components
        st = self._pending.get(key)
        if st is not None:
            # aggregate: one request in flight, many waiters
            st["waiters"].append((on_data, on_fail))
            st["retries"] = max(st["retries"], retries)
            return
        self._pending[key] = {"waiters": [(on_data, on_fail)],
                              "retries": retries, "interest": interest,
                              "rto": rto, "sent": self.net.now,
                              "noroute_retries": 0}
        self.net.schedule(0.0, self._inject, arg=interest)
        self._arm_timeout(interest)
        if hedge_delay is not None:
            nonce = interest.nonce
            self.net.schedule(hedge_delay,
                              lambda: self._hedge(key, nonce))

    def _inject(self, interest: Interest) -> None:
        self.expressed += 1
        self.node.receive(self.face.face_id, interest)

    def get(self, name: Name, retries: int = 3, **kw) -> Dict[str, Any]:
        """Express and run the network to quiescence; returns a result box."""
        box: Dict[str, Any] = {}
        self.express(Interest(name=name, **kw),
                     on_data=lambda d: box.__setitem__("data", d),
                     on_fail=lambda r: box.__setitem__("error", r),
                     retries=retries)
        self.net.run()
        return box

    def _arm_timeout(self, interest: Interest) -> None:
        key = interest.name.components

        def timeout() -> None:
            st = self._pending.get(key)
            if st is None or st["interest"].nonce != interest.nonce:
                return  # answered, or superseded by a retransmission
            budget = self.retry_budget
            if st["retries"] > 0 and (
                    budget is None
                    or budget.try_spend(key[:2], self.net.now)):
                st["retries"] -= 1
                fresh = interest.refresh()
                st["interest"] = fresh
                self.expressed += 1
                self.node.receive(self.face.face_id, fresh)
                self._arm_timeout(fresh)
            else:
                del self._pending[key]
                self._fail_waiters(st, reasons.TIMEOUT)

        # retransmit *before* the upstream PIT entry expires (RTO < lifetime)
        # so forwarders see a live entry + fresh nonce — the retransmission
        # signal that lets them immediately try an untried upstream
        st = self._pending.get(key)
        rto = st.get("rto") if st else None
        self.net.schedule(rto if rto is not None else interest.lifetime * 0.9,
                          timeout)

    @staticmethod
    def _fail_waiters(st: Dict[str, Any], reason: str) -> None:
        for _, on_fail in st["waiters"]:
            if on_fail:
                on_fail(reason)

    def _receive(self, packet: Any) -> None:
        if isinstance(packet, Data):
            # a Data answers every pending name that is a prefix of (or equal
            # to) its name — walk the prefixes, don't scan the pending table
            comps = packet.name.components
            for i in range(len(comps) + 1):
                st = self._pending.pop(comps[:i], None)
                if st is not None:
                    self.satisfied += 1
                    for on_data, _ in st["waiters"]:
                        on_data(packet)
        elif isinstance(packet, Nack):
            self.nacks.append(packet)
            st = self._pending.get(packet.name.components)
            # NACK is advisory: keep the timeout armed (a retransmission may
            # reach a cluster that just joined), but report if out of retries.
            if st is None:
                return
            if st["retries"] == 0:
                self._pending.pop(packet.name.components)
                self._fail_waiters(st, reasons.nack_failure(packet.reason))
            elif (packet.reason == reasons.NO_ROUTE
                  and self.noroute_policy.allows(st["noroute_retries"] + 1)):
                # a no-route NACK during route convergence is transient:
                # the decentralized control plane is still gossiping this
                # prefix hop-by-hop.  Retry on the named backoff schedule
                # (bounded, deterministic, does not consume `retries`)
                # instead of burning most of an interest lifetime.
                st["noroute_retries"] += 1
                backoff = self.noroute_policy.delay(st["noroute_retries"])
                nonce = st["interest"].nonce
                self.net.schedule(backoff,
                                  lambda: self._fast_retransmit(
                                      packet.name.components, nonce))

    def _fast_retransmit(self, key: Tuple[str, ...], nonce: int) -> None:
        st = self._pending.get(key)
        if st is None or st["interest"].nonce != nonce:
            return  # answered, failed, or superseded meanwhile
        fresh = st["interest"].refresh()
        st["interest"] = fresh
        self.expressed += 1
        self.node.receive(self.face.face_id, fresh)
        self._arm_timeout(fresh)

    def _hedge(self, key: Tuple[str, ...], nonce: int) -> None:
        """Fire the hedged second Interest iff the original is still the
        one in flight (no answer, no retransmission happened first)."""
        st = self._pending.get(key)
        if st is None or st["interest"].nonce != nonce:
            return
        self.hedges += 1
        self._fast_retransmit(key, nonce)
