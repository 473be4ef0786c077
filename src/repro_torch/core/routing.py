"""In-band name-prefix routing: the decentralized control plane.

This module replaces global-BFS route installation with an NLSR-style
protocol that runs *on the virtual clock, over the same faces the data
plane uses*.  Each node attaches a :class:`RoutingAgent` to its forwarder
and talks **only to its neighbors**:

* **Prefix advertisements** — signed, sequence-numbered, lifetime-bounded
  records ``(prefix, origin, seq, cost, path, caps)``.  An origin
  advertises the prefixes it serves (data prefixes *and* compute
  capability records: chips, free chips, queue depth); every node
  re-advertises its *best* route per (prefix, origin) to its neighbors,
  path-vector style, so loops are structurally impossible (a node drops
  any advertisement whose path already contains it).
* **RIB / FIB split** — everything heard goes into the node's
  :class:`~repro_torch.core.tables.Rib`; the FIB is *derived locally*
  (:meth:`Rib.nexthops` -> :meth:`Fib.sync_prefix`): multi-path nexthops
  ranked by advertised cost, with equal-ish-cost detours kept within a
  configurable slack so strategies can fail over before re-convergence.
* **Withdrawals** — a graceful leave floods an origin-signed withdrawal
  (sequence-gated tombstones stop stale in-flight advertisements from
  resurrecting the prefix); a node that loses its last route for an
  origin sends hop-local *retractions* so downstream FIBs never keep a
  nexthop the sender can no longer honor.
* **Hello / failure detection** — periodic hellos per adjacency plus a
  local carrier check; a dead neighbor's routes are purged and the
  resulting changes propagate as triggered updates.  A neighbor heard
  again after death gets a full-table resync (this is also how a healed
  partition re-converges).
* **Stale-entry expiry** — every advertisement carries its origin's
  lifetime; a route that is not refreshed (origins re-originate with a
  fresh sequence number every ``refresh_interval``) expires out of the
  RIB and the FIB follows.

All control traffic is ordinary Interests under ``/lidc/rt/`` sent
hop-by-hop (never forwarded), marked *daemon* on the event queue so the
protocol heartbeat never prevents the network from quiescing — see
:class:`~repro_torch.core.forwarder.Network`.

The old global BFS survives only as the property-test / benchmark oracle
(:meth:`repro_torch.core.overlay.MeshTopology.oracle_distances`).

The port's copy of ``repro/core/routing.py``: the same logic, its imports
pointing inside ``repro_torch``.
"""

from __future__ import annotations

import hashlib
import hmac
import itertools
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Set, Tuple

from .forwarder import CONTROL_PREFIX, Face, Forwarder
from .names import Name
from .packets import Interest
from .tables import Key, Rib, RibRoute

__all__ = ["RoutingConfig", "RoutingAgent", "capability_cost",
           "CONTROL_PREFIX"]


@dataclass
class RoutingConfig:
    """Protocol timers and policy, shared by every agent in a deployment."""

    hello_interval: float = 0.25     # heartbeat cadence while converging
    dead_interval: float = 6.0       # hello-silence bound (>= 3 hellos at
                                     # the idle cadence; lowering it also
                                     # lowers the idle backoff cap so the
                                     # bound genuinely holds)
    adv_lifetime: float = 30.0       # advertisement lifetime (stale bound)
    refresh_interval: float = 10.0   # origins re-originate this often
    batch_delay: float = 0.001       # triggered updates coalesce this long
    multipath_slack: float = 1.0     # keep nexthops within best + slack
    link_cost: float = 1.0           # per-hop cost increment
    max_batch: int = 64              # advertisements per control message
    idle_backoff_cap: float = 2.0    # max heartbeat interval when stable
    sign_key: Optional[bytes] = b"lidc-routing-key"   # None disables signing
    # steady-state cost controls (all three default on; the engine_speed
    # benchmark's "legacy" baseline turns them off to reproduce the old
    # protocol's behavior exactly):
    keepalive_refresh: bool = True   # refresh soft state via one tiny
                                     # per-adjacency keepalive per interval
                                     # ("everything I advertised to you is
                                     # still good") instead of re-flooding
                                     # every advertisement; an origin whose
                                     # capability record changed still falls
                                     # back to a full re-origination
    slot_heartbeats: bool = True     # deterministically phase-offset each
                                     # node's heartbeat + refresh wave so 1000
                                     # agents don't tick at the same instant
    hello_suppression: bool = True   # skip a hello when any control message
                                     # already went to that neighbor within
                                     # the current heartbeat interval

    @property
    def hello_timeout(self) -> float:
        """Hello-silence threshold for declaring a neighbor dead.  The
        *fast* failure detector is the local carrier check (``face.down``),
        judged every heartbeat; this bound catches silent failures (e.g. a
        lossy-but-up link) and is honored because the idle heartbeat never
        backs off past :meth:`effective_backoff_cap` = dead_interval/3."""
        return max(self.dead_interval, 3.0 * self.hello_interval)

    @property
    def effective_backoff_cap(self) -> float:
        """Idle-heartbeat ceiling: never so slow that a healthy peer's
        hellos would miss the ``dead_interval`` silence bound."""
        return max(self.hello_interval,
                   min(self.idle_backoff_cap, self.dead_interval / 3.0))


def capability_cost(caps: Optional[Dict[str, Any]]) -> float:
    """Origin-side cost seed derived from a capability record.

    A loaded cluster (no free chips, deep admission queue, high median
    predicted completion) advertises a higher base cost, so strategies
    that seed their ranking from the FIB cost — cold-prefix probing in
    AdaptiveStrategy — prefer clusters that advertised spare capacity,
    before a single Interest has been sent.  ``eta_p50`` is the compute
    plane's gossiped median predicted completion over its queue (see
    :meth:`repro_torch.core.compute_plane.ClusterScheduler.eta_p50`): the
    paper's §VII "predict completion times" signal, folded into route
    cost with a cap so a pathological quote cannot black-hole a cluster.
    """
    if not caps:
        return 0.0
    if caps.get("replica"):
        # a managed data replica advertises *data availability*, not
        # compute capacity: its cost is pure hop distance, so strategies
        # steer readers to the nearest copy instead of penalizing the
        # replica for having no chips to offer
        return 0.0
    cost = 0.0
    chips = caps.get("chips")
    free = caps.get("free_chips", chips)
    if chips is not None and int(chips) <= 0:
        cost += 4.0          # advertised itself out of capacity
    elif free is not None and int(free) <= 0:
        cost += 0.5          # full right now; queued admission territory
    cost += 0.125 * float(caps.get("queue_depth", 0))
    cost += min(2.0, 0.25 * float(caps.get("eta_p50", 0.0)))
    return cost


# Sequence numbers must be monotonic per (prefix, origin) across agent
# *incarnations*: a cluster that left (flooding withdrawals at seq N) and
# rejoins under the same name gets a brand-new agent whose advertisements
# must outrun the tombstones its predecessor left behind — even when the
# leave and the rejoin happen at the same virtual instant.  Real NLSR
# persists each router's sequence number to disk; this process-wide
# high-water mark is the in-process stand-in for that file.
_seq_highwater = 0


# Signature memo: the same advertisement is verified once per receiving
# node per flood wave — with keepalive refresh the (origin, prefix, seq)
# tuple stays stable for many waves, so the HMAC for it is computed once
# process-wide.  Bounded clear-on-full, like the Name parse cache.
_SIGN_CACHE: Dict[Tuple, str] = {}
_SIGN_CACHE_MAX = 16384


def _sign(key: bytes, origin: str, prefix: str, seq: int, lifetime: float,
          withdraw: bool, caps: Optional[Dict[str, Any]]) -> str:
    # cheap deterministic canonicalization — this runs for every received
    # advertisement over multi-hour virtual runs, so no json round-trips
    caps_canon = repr(sorted(caps.items())) if caps else ""
    ck = (key, origin, prefix, seq, lifetime, withdraw, caps_canon)
    sig = _SIGN_CACHE.get(ck)
    if sig is not None:
        return sig
    canon = f"{origin}|{prefix}|{seq}|{lifetime}|{int(withdraw)}|{caps_canon}"
    sig = hmac.new(key, canon.encode(), hashlib.sha256).hexdigest()[:16]
    if len(_SIGN_CACHE) >= _SIGN_CACHE_MAX:
        _SIGN_CACHE.clear()
    _SIGN_CACHE[ck] = sig
    return sig


def _adv_wire_size(adv: Dict[str, Any]) -> int:
    """Approximate serialized size without serializing (overhead metric)."""
    size = 24 + len(adv.get("p", "")) + len(adv.get("o", ""))
    for c in adv.get("pa", ()):
        size += len(c) + 1
    caps = adv.get("cp")
    if caps:
        size += 8 * len(caps)
        for k in caps:
            size += len(k)
    return size


@dataclass
class _Neighbor:
    face: Face
    name: Optional[str] = None       # learned from the peer's messages
    alive: bool = True
    last_heard: float = 0.0
    # prefix -> origin -> (seq, cost) last advertised to this neighbor
    advertised: Dict[str, Dict[str, Tuple[int, float]]] = field(
        default_factory=dict)
    # (prefix, origin) -> advertisement queued for the next batch
    pending: Dict[Tuple[str, str], Dict[str, Any]] = field(
        default_factory=dict)
    # virtual time of the last control message *we* sent this neighbor —
    # any control traffic proves our liveness, so a hello inside the same
    # heartbeat interval is redundant (hello suppression)
    last_tx: float = float("-inf")
    # adjacency epoch: bumped every time *we* declare this neighbor dead
    # (i.e. we purged everything we learned from it) — and every time a
    # keepalive count digest reveals the peer believes it delivered
    # adverts we never received (lost on a lossy or flapping link).
    # Carried in our hellos so the peer can tell we reset the adjacency
    # and resync to us.  The old protocol repaired such asymmetric
    # resets implicitly — every refresh re-flooded every advertisement;
    # keepalive refresh removes those floods, so the repair must be
    # explicit.
    my_epoch: int = 0
    # the last epoch value heard from the peer (None until first hello)
    peer_epoch: Optional[int] = None


@dataclass
class _Origin:
    prefix: Name
    seq: int
    caps: Optional[Dict[str, Any]]
    lifetime: float


class RoutingAgent:
    """One node's routing process: RIB in, derived FIB out, gossip across.

    Attach with ``RoutingAgent(forwarder)`` (registers itself as
    ``forwarder.routing``), declare adjacencies with :meth:`add_neighbor`,
    and :meth:`start` the heartbeat.  Everything else — origination,
    dissemination, failure detection, expiry — is protocol traffic.
    """

    def __init__(self, node: Forwarder, config: Optional[RoutingConfig] = None,
                 *, name: Optional[str] = None):
        self.node = node
        self.net = node.net
        self.cfg = config or RoutingConfig()
        self.name = name or node.name
        self.rib = Rib()
        self.neighbors: Dict[int, _Neighbor] = {}
        self.origins: Dict[str, _Origin] = {}
        # optional callable returning the node's *current* capability
        # record; consulted at every refresh so load signals (free chips,
        # queue depth) stay live instead of frozen at origination
        self.caps_provider: Optional[Any] = None
        self._seq = itertools.count(1)
        self._msg_seq = itertools.count(1)
        # deterministic per-node phase in [0, 1): offsets the heartbeat and
        # the refresh wave so a large fleet doesn't tick in lockstep.
        # crc32, not hash() — hash() is salted per process and would break
        # run-to-run reproducibility of the virtual-clock schedule.
        self._phase = (zlib.crc32(self.name.encode()) % 997) / 997.0
        # (prefix, origin) -> (withdrawn seq, tombstone expiry)
        self._tombstones: Dict[Tuple[str, str], Tuple[int, float]] = {}
        self._dirty: Set[Key] = set()
        self._flush_scheduled = False
        self._started = False
        self._stopped = False
        self._last_refresh = 0.0
        # heartbeat idle backoff: full cadence while anything changes,
        # decaying toward the cap when the protocol is quiescent — long
        # virtual runs (multi-hour jobs) must not drown in hello events
        self._interval = self.cfg.hello_interval
        self._active = True
        self.stats = {"msgs_sent": 0, "msgs_rcvd": 0, "advs_sent": 0,
                      "advs_rcvd": 0, "bytes_sent": 0, "hellos_sent": 0,
                      "withdraws_sent": 0, "retractions_sent": 0,
                      "dropped_loops": 0, "dropped_bad_sig": 0,
                      "neighbor_deaths": 0, "fib_syncs": 0,
                      "keepalives_sent": 0, "keepalives_rcvd": 0,
                      "resyncs_requested": 0, "sends_deferred": 0}
        node.routing = self

    def _next_seq(self) -> int:
        """Next origination sequence number, monotonic across every agent
        incarnation in this process (see ``_seq_highwater`` above)."""
        global _seq_highwater
        seq = max(next(self._seq), _seq_highwater + 1)
        _seq_highwater = seq
        return seq

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        """Arm the heartbeat (idempotent).  Daemon events only — an idle
        network still quiesces; the heartbeat runs whenever live traffic
        or a ``run(until=...)`` horizon moves the clock."""
        if self._started:
            return
        self._started = True
        self._last_refresh = self.net.now
        first = self.cfg.hello_interval
        if self.cfg.slot_heartbeats:
            # slot the first tick inside [0.5, 1.5) intervals and stagger
            # the refresh wave across the whole refresh_interval — a 1000
            # agent fleet must not phase-align its heartbeats or re-flood
            # every prefix at the same virtual instant
            first *= 0.5 + self._phase
            self._last_refresh -= self._phase * self.cfg.refresh_interval
        self.net.schedule(first, self._tick, daemon=True)

    def stop(self) -> None:
        """Retire the agent: the heartbeat stops rescheduling itself and
        neighbor state is dropped.  A removed cluster's agent must not
        zombie-tick for the rest of a long simulation."""
        self._stopped = True
        self.neighbors.clear()

    def add_neighbor(self, face: Face) -> None:
        """Declare a routing adjacency over ``face`` (one direction; the
        peer declares its own).  New adjacencies get a full-table sync."""
        nb = _Neighbor(face=face, last_heard=self.net.now)
        self.neighbors[face.face_id] = nb
        self._full_sync(nb)

    def remove_neighbor(self, face_id: int) -> None:
        """Drop an adjacency for good (the peer was removed, not merely
        failed): purge its routes and stop iterating it every heartbeat."""
        nb = self.neighbors.pop(face_id, None)
        if nb is not None:
            for key in self.rib.remove_face(face_id):
                self._mark_dirty(key)

    # -------------------------------------------------------------- origins
    def originate(self, prefix: Name, caps: Optional[Dict[str, Any]] = None,
                  lifetime: Optional[float] = None) -> None:
        """(Re-)announce a locally served prefix.  Re-originating bumps the
        sequence number, so capability changes propagate immediately."""
        self.origins[str(prefix)] = _Origin(
            prefix=prefix, seq=self._next_seq(), caps=caps,
            lifetime=lifetime if lifetime is not None else self.cfg.adv_lifetime)
        self._tombstones.pop((str(prefix), self.name), None)
        self._mark_dirty(prefix.components)

    def withdraw(self, prefix: Name) -> None:
        """Gracefully withdraw a local prefix: an origin-signed withdrawal
        floods the overlay and tombstones stop stale resurrections."""
        o = self.origins.pop(str(prefix), None)
        if o is None:
            return
        seq = self._next_seq()
        self._tombstones[(str(prefix), self.name)] = (
            seq, self.net.now + o.lifetime)
        adv: Dict[str, Any] = {"p": str(prefix), "o": self.name, "s": seq,
                               "w": 1, "lt": o.lifetime}
        if self.cfg.sign_key is not None:
            adv["sig"] = _sign(self.cfg.sign_key, self.name, str(prefix),
                               seq, o.lifetime, True, None)
        self._queue_to_all(adv)
        self.stats["withdraws_sent"] += 1
        self._mark_dirty(prefix.components)

    def withdraw_all(self) -> None:
        for prefix_s in list(self.origins):
            self.withdraw(Name.parse(prefix_s))

    def flush_now(self) -> None:
        """Send queued control traffic immediately (e.g. a graceful leave
        must put its withdrawals on the wire before the links drop)."""
        self._flush()

    def poke(self) -> None:
        """Run one failure-detection + expiry + hello + flush round *now*
        (the event-driven equivalent of the next heartbeat).  Used by the
        ``refresh_routes`` compatibility shim and by operators that know
        the topology just changed; strictly local — it only reads this
        node's own faces and RIB and sends to its own neighbors.  It does
        NOT bump origin sequence numbers: triggered updates already cover
        every route that changed, and a forced re-origination here would
        re-flood all prefixes from all poked nodes on every churn event.
        The immediate hellos make a healed adjacency resync now instead
        of at the next heartbeat."""
        now = self.net.now
        for nb in self.neighbors.values():
            if nb.alive and nb.face.down:
                self._neighbor_down(nb)
        for key in self.rib.expire(now):
            self._mark_dirty(key)
        for nb in self.neighbors.values():
            # unconditional (no suppression): poke() is the heal/resync
            # path and a healed adjacency needs to hear us *now*
            if not nb.face.down:
                nb.face.send(self._control_interest(
                    {"t": "hello", "n": self.name, "e": nb.my_epoch}),
                    daemon=True)
                nb.last_tx = now
                self.stats["hellos_sent"] += 1
        self._flush()

    # ---------------------------------------------------------- link events
    def on_face_down(self, face_id: int) -> None:
        """Forwarder-reported link failure: purge + triggered updates."""
        nb = self.neighbors.get(face_id)
        if nb is not None and nb.alive:
            self._neighbor_down(nb)

    # ----------------------------------------------------------- rx pipeline
    def handle_control(self, face_id: int, interest: Interest) -> None:
        nb = self.neighbors.get(face_id)
        if nb is None:
            return      # control from a non-adjacent face: ignore
        self.stats["msgs_rcvd"] += 1
        payload = interest.app_params or {}
        sender = payload.get("n")
        if sender is not None:
            nb.name = sender
        now = self.net.now
        half_open = nb.face.down
        if not half_open:
            was_dead = not nb.alive
            nb.alive = True
            nb.last_heard = now
            if was_dead:
                # the adjacency came back (healed link/partition): resync
                self._active = True
                nb.advertised.clear()
                self._full_sync(nb)
            epoch = payload.get("e")
            if epoch is not None and epoch != nb.peer_epoch:
                first_contact = nb.peer_epoch is None
                nb.peer_epoch = epoch
                if not first_contact and not was_dead:
                    # the peer declared *us* dead at some point (it purged
                    # every route we ever advertised to it) while we never
                    # noticed the outage — one-sided resets happen when
                    # only one side's heartbeat fires inside the outage
                    # window.  Resync our offers to it.
                    self._active = True
                    nb.advertised.clear()
                    self._full_sync(nb)
        advs = payload.get("advs", ())
        if advs:
            self._active = True
        for adv in advs:
            # half-open link (we hear the peer, but anything we forward out
            # this face vanishes): never install routes through it, but
            # state-*removing* messages — a graceful leave's withdrawals
            # are in flight exactly when the link drops — stay valid
            if half_open and not (adv.get("w") or adv.get("r")):
                continue
            self.stats["advs_rcvd"] += 1
            self._process_adv(nb, adv, now)
        if payload.get("kf") and not half_open:
            # face-scoped keepalive: "every route I ever advertised to you
            # is still good" — extend everything learned over this face by
            # its own advertised lifetime, in place.  Hop-by-hop soft state:
            # nothing is re-flooded, no FIB work (costs and nexthops are
            # unchanged — that is the whole point), and ``_active`` stays
            # untouched so the idle heartbeat backoff it protects survives.
            self.stats["keepalives_rcvd"] += 1
            self.rib.extend_face(face_id, now)
            kc = payload.get("kc")
            if kc is not None and kc != self.rib.count_face(face_id):
                # count digest mismatch: the peer believes it delivered
                # adverts we never received (eaten by a lossy or flapping
                # link — keepalives extend soft state but cannot resurrect
                # a route that never arrived).  Bump our adjacency epoch:
                # the hello makes the peer clear its delivery record and
                # full-resync to us.  Gray-failure repair without
                # reintroducing the per-refresh re-flood.
                self._active = True
                nb.my_epoch += 1
                nb.face.send(self._control_interest(
                    {"t": "hello", "n": self.name, "e": nb.my_epoch}),
                    daemon=True)
                nb.last_tx = now
                self.stats["hellos_sent"] += 1
                self.stats["resyncs_requested"] += 1

    def _process_adv(self, nb: _Neighbor, adv: Dict[str, Any],
                     now: float) -> None:
        prefix_s = adv.get("p")
        origin = adv.get("o")
        if not prefix_s or not origin:
            return
        name = Name.parse(prefix_s)
        if adv.get("r"):
            # hop-local retraction: the sender no longer offers this route
            if self.rib.remove(name, origin=origin, face_id=nb.face.face_id):
                self._mark_dirty(name.components)
            return
        seq = int(adv["s"])
        lifetime = float(adv["lt"])
        caps = adv.get("cp")
        withdraw = bool(adv.get("w"))
        if self.cfg.sign_key is not None:
            want = _sign(self.cfg.sign_key, origin, prefix_s, seq, lifetime,
                         withdraw, caps)
            if adv.get("sig") != want:
                self.stats["dropped_bad_sig"] += 1
                return
        ts = self._tombstones.get((prefix_s, origin))
        if ts is not None and seq <= ts[0]:
            return      # at or before a known withdrawal: stale
        if withdraw:
            self._tombstones[(prefix_s, origin)] = (seq, now + lifetime)
            if self.rib.remove(name, origin=origin):
                self._mark_dirty(name.components)
            for other in self.neighbors.values():
                other.advertised.get(prefix_s, {}).pop(origin, None)
            self._queue_to_all(adv, exclude_face=nb.face.face_id)
            return
        path = tuple(adv.get("pa", ()))
        if self.name in path:
            self.stats["dropped_loops"] += 1
            return
        prior = self.rib.routes(name).get((origin, nb.face.face_id))
        if prior is not None and seq < prior.seq:
            return      # reordered stale advert (jittered links can deliver
                        # out of order): never let it overwrite a fresher
                        # route; equal seq is allowed — cost/path updates
                        # within one origination ride the same seq
        route = RibRoute(
            origin=origin, face_id=nb.face.face_id, seq=seq,
            cost=float(adv["c"]) + self.cfg.link_cost, path=path,
            expires_at=now + lifetime,
            caps=dict(caps) if caps is not None else None,
            lifetime=lifetime, sig=adv.get("sig", ""))
        if self.rib.upsert(name, route):
            self._mark_dirty(name.components)

    # ------------------------------------------------------------ heartbeat
    def _tick(self) -> None:
        now = self.net.now
        # 1. failure detection: local carrier (fast) + hello silence (slow)
        for nb in self.neighbors.values():
            if nb.alive and (nb.face.down
                             or now - nb.last_heard > self.cfg.hello_timeout):
                self._neighbor_down(nb)
        # 2. stale-entry expiry (unrefreshed advertisements die)
        for key in self.rib.expire(now):
            self._mark_dirty(key)
        for ts_key in [k for k, (_, exp) in self._tombstones.items()
                       if exp <= now]:
            del self._tombstones[ts_key]
        # 3. soft-state refresh: downstream lifetimes must be extended
        #    before adv_lifetime runs out.  Steady state sends one tiny
        #    *face-scoped* keepalive per alive adjacency we have advertised
        #    routes to ("everything I offered you is still good"); the
        #    receiver extends every route learned over that face in place.
        #    No flooding — keepalive cost is per-link, not per-origin×links.
        #    A *changed* capability record — the live free-chips / queue-
        #    depth gossip — falls back to a full re-origination with a new
        #    seq, exactly the old protocol.
        if now - self._last_refresh >= self.cfg.refresh_interval:
            self._last_refresh = now
            caps = self.caps_provider() if self.caps_provider else None
            caps_changed = caps is not None and any(
                o.caps != caps for o in self.origins.values())
            if self.origins and (caps_changed
                                 or not self.cfg.keepalive_refresh):
                for o in self.origins.values():
                    o.seq = self._next_seq()
                    if caps is not None:
                        o.caps = caps
                    self._mark_dirty(o.prefix.components)
            elif self.cfg.keepalive_refresh:
                ka_bytes = 24 + len(self.name) + 4
                for nb in self.neighbors.values():
                    if nb.face.down or not nb.alive or not nb.advertised:
                        continue
                    # the count digest lets the receiver detect adverts
                    # that never arrived (lossy/flapping link) and request
                    # a resync — see the ``kc`` check in handle_control
                    kc = sum(len(d) for d in nb.advertised.values())
                    nb.face.send(self._control_interest(
                        {"t": "ka", "n": self.name, "kf": 1, "kc": kc}),
                        daemon=True)
                    nb.last_tx = now
                    self.stats["keepalives_sent"] += 1
                    self.stats["msgs_sent"] += 1
                    self.stats["bytes_sent"] += ka_bytes
        # 4. hellos (suppressed per neighbor when any control message
        #    already proved our liveness within this heartbeat interval —
        #    adv/keepalive traffic doubles as the hello)
        if self.neighbors:
            suppress = self.cfg.hello_suppression
            for nb in self.neighbors.values():
                if nb.face.down:
                    continue
                if suppress and now - nb.last_tx < self._interval:
                    continue
                nb.face.send(self._control_interest(
                    {"t": "hello", "n": self.name, "e": nb.my_epoch}),
                    daemon=True)
                nb.last_tx = now
                self.stats["hellos_sent"] += 1
        # 4b. drain adverts deferred while a flapping face was down
        self._send_pending()
        # 5. idle backoff: quiescent protocol -> slower heartbeat
        if self._active:
            self._interval = self.cfg.hello_interval
        else:
            self._interval = min(self._interval * 2.0,
                                 self.cfg.effective_backoff_cap)
        self._active = False
        if not self._stopped:
            iv = self._interval
            if self.cfg.slot_heartbeats:
                # +/-5% deterministic skew keeps a fleet that started in
                # lockstep from re-aligning after the backoff converges
                iv *= 0.95 + 0.1 * self._phase
            self.net.schedule(iv, self._tick, daemon=True)

    def _neighbor_down(self, nb: _Neighbor) -> None:
        nb.alive = False
        nb.advertised.clear()
        nb.pending.clear()
        nb.my_epoch += 1    # we purged this adjacency: signal it in hellos
        self._active = True
        self.stats["neighbor_deaths"] += 1
        for key in self.rib.remove_face(nb.face.face_id):
            self._mark_dirty(key)

    # ---------------------------------------------------------- tx pipeline
    def _schedule_flush(self) -> None:
        if not self._flush_scheduled:
            self._flush_scheduled = True
            self.net.schedule(self.cfg.batch_delay, self._flush, daemon=True)

    def _mark_dirty(self, key: Key) -> None:
        self._active = True
        self._dirty.add(key)
        self._schedule_flush()

    def _full_sync(self, nb: _Neighbor) -> None:
        """Mark every known prefix dirty; only ``nb`` (whose advertised
        record is empty) actually receives traffic for unchanged routes."""
        for o in self.origins.values():
            self._mark_dirty(o.prefix.components)
        for name in self.rib.prefixes():
            self._mark_dirty(name.components)

    def _flush(self) -> None:
        self._flush_scheduled = False
        now = self.net.now
        dirty, self._dirty = self._dirty, set()
        for key in sorted(dirty):
            name = Name(key)
            if self.node.fib.sync_prefix(
                    name, self.rib.nexthops(
                        name, slack=self.cfg.multipath_slack)):
                self.stats["fib_syncs"] += 1
            self._requeue(name, now)
        self._send_pending()

    def _best_adverts(self, name: Name) -> Dict[str, Dict[str, Any]]:
        """My current best advertisement per origin for one prefix."""
        prefix_s = str(name)
        bests: Dict[str, Dict[str, Any]] = {}
        o = self.origins.get(prefix_s)
        if o is not None:
            adv: Dict[str, Any] = {"p": prefix_s, "o": self.name, "s": o.seq,
                                   "c": capability_cost(o.caps),
                                   "pa": [self.name], "lt": o.lifetime}
            if o.caps is not None:
                adv["cp"] = o.caps
            if self.cfg.sign_key is not None:
                adv["sig"] = _sign(self.cfg.sign_key, self.name, prefix_s,
                                   o.seq, o.lifetime, False, o.caps)
            bests[self.name] = adv
        for origin in self.rib.origins(name):
            if origin in bests:
                continue
            r = self.rib.best(name, origin)
            if r is None:
                continue
            adv = {"p": prefix_s, "o": origin, "s": r.seq, "c": r.cost,
                   "pa": list(r.path) + [self.name], "lt": r.lifetime}
            if r.caps is not None:
                adv["cp"] = r.caps
            if r.sig:
                adv["sig"] = r.sig
            bests[origin] = adv
        return bests

    def _requeue(self, name: Name, now: float) -> None:
        prefix_s = str(name)
        bests = self._best_adverts(name)
        for nb in self.neighbors.values():
            if not nb.alive:
                continue
            record = nb.advertised.setdefault(prefix_s, {})
            # what I can offer *this* neighbor: my best per origin, minus
            # routes that run through the neighbor itself (split horizon —
            # it would drop them on the path filter anyway)
            offered = {origin: adv for origin, adv in bests.items()
                       if nb.name is None or nb.name not in adv["pa"]}
            for origin, adv in offered.items():
                cur = (adv["s"], adv["c"])
                if record.get(origin) != cur:
                    record[origin] = cur
                    nb.pending[(prefix_s, origin)] = adv
            for origin in [o for o in record if o not in offered]:
                # I advertised this route before and can no longer honor
                # it for this neighbor — either the route is gone, or my
                # best now runs *through* the neighbor (poisoned reverse:
                # without the retraction it would keep a stale route back
                # through me)
                del record[origin]
                queued = nb.pending.get((prefix_s, origin))
                if queued is not None and queued.get("w"):
                    continue    # an origin withdrawal is already queued —
                                # it kills the route harder than a retraction
                nb.pending[(prefix_s, origin)] = {"p": prefix_s, "o": origin,
                                                  "r": 1}
                self.stats["retractions_sent"] += 1
            if not record:
                del nb.advertised[prefix_s]

    def _queue_to_all(self, adv: Dict[str, Any],
                      exclude_face: Optional[int] = None) -> None:
        for fid, nb in self.neighbors.items():
            if fid == exclude_face or not nb.alive:
                continue
            nb.pending[(adv["p"], adv["o"])] = adv
        # piggyback on the dirty-flush scheduler
        self._schedule_flush()

    def _send_pending(self) -> None:
        now = self.net.now
        for nb in self.neighbors.values():
            if not nb.pending:
                continue
            if nb.face.down:
                # a down face would eat the batch while ``advertised``
                # records it as delivered — a flap shorter than one
                # heartbeat would then leave the peer permanently missing
                # the route.  Hold pending; the heartbeat drains it once
                # the carrier is back (or _neighbor_down clears it).
                self.stats["sends_deferred"] += 1
                continue
            advs = list(nb.pending.values())
            nb.pending.clear()
            for i in range(0, len(advs), self.cfg.max_batch):
                batch = advs[i:i + self.cfg.max_batch]
                msg = self._control_interest(
                    {"t": "adv", "n": self.name, "advs": batch})
                nb.face.send(msg, daemon=True)
                nb.last_tx = now
                self.stats["msgs_sent"] += 1
                self.stats["advs_sent"] += len(batch)
                self.stats["bytes_sent"] += sum(map(_adv_wire_size, batch))

    def _control_interest(self, payload: Dict[str, Any]) -> Interest:
        name = Name(CONTROL_PREFIX + (self.name, str(next(self._msg_seq))))
        return Interest(name=name, lifetime=1.0, app_params=payload)

    # ------------------------------------------------------------- queries
    def advertised_capabilities(self, prefix: Name) -> Dict[str, Dict]:
        """What the network told this node about who serves ``prefix``."""
        return self.rib.capabilities(prefix)

    def converged_with(self, other: "RoutingAgent") -> bool:
        """Debug helper: do two agents agree on reachable (prefix, origin)
        sets?  (Costs legitimately differ by distance.)"""
        mine = {(str(p), o) for p in self.rib.prefixes()
                for o in self.rib.origins(p)}
        theirs = {(str(p), o) for p in other.rib.prefixes()
                  for o in other.rib.origins(p)}
        return mine == theirs
