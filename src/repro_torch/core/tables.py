"""RIB, FIB, PIT and Content Store — the NDN control/forwarding tables.

* RIB: the *routing* information base — every prefix advertisement a node
  has heard from its neighbors (per origin, per face, sequence-numbered
  and lifetime-bounded).  The RIB is protocol state; the FIB is derived
  from it locally (:meth:`Rib.nexthops` -> :meth:`Fib.sync_prefix`), which
  is the paper's decentralized control plane: no node ever installs a
  route it did not learn hop-by-hop.
* FIB: longest-prefix-match over announced name prefixes -> next-hop faces,
  with per-nexthop cost and health (strategies rank on these).  The match
  runs over a *compressed name-component trie* so a lookup costs
  O(len(name)) regardless of how many prefixes the overlay announces —
  the linear-scan implementation survives as :class:`LinearFib`, the
  benchmark baseline and the property-test oracle.
* PIT: pending Interests; aggregates same-name requests (many consumers,
  one upstream fetch), suppresses duplicate nonces (loop prevention), and
  expires entries at interest lifetime — expiry is what drives
  retransmission and therefore failover.  Entries are hash-indexed and
  expiry rides a lazy min-heap, so neither satisfaction nor expiry scans
  the table.
* Content Store: LRU cache of Data packets with a prefix hash-index so
  ``can_be_prefix`` matches and prefix invalidation are index lookups,
  not scans.  This is simultaneously NDN's in-network cache and the
  paper's §VII future-work *result cache* — because job names are
  canonical, two identical compute requests hash to the same name and
  the second is served from the CS.

The port's copy of ``repro/core/tables.py``: the same logic, its imports
pointing inside ``repro_torch``.
"""

from __future__ import annotations

import heapq
import itertools
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .names import Name
from .packets import Data, Interest

__all__ = ["Fib", "LinearFib", "NextHop", "Pit", "PitEntry", "ContentStore",
           "Rib", "RibRoute"]

Key = Tuple[str, ...]


# ---------------------------------------------------------------------------
# FIB
# ---------------------------------------------------------------------------

@dataclass
class NextHop:
    face_id: int
    cost: float = 1.0
    healthy: bool = True
    # moving success statistics maintained by strategies / measurements
    rtt_ewma: float = 0.0
    loss_ewma: float = 0.0
    successes: int = 0
    failures: int = 0
    pending: int = 0          # interests forwarded, not yet answered
    last_used: float = 0.0    # when a strategy last forwarded through here
    # predicted-completion quote from the upstream's last busy receipt
    # (seconds; 0 = never quoted / recovered).  Decays on success so a
    # cluster that stops being busy wins traffic back.
    eta_ewma: float = 0.0

    def record(self, ok: bool, rtt: float = 0.0, alpha: float = 0.3) -> None:
        if ok:
            self.successes += 1
            self.rtt_ewma = rtt if self.rtt_ewma == 0 else (1 - alpha) * self.rtt_ewma + alpha * rtt
            self.loss_ewma = (1 - alpha) * self.loss_ewma
            self.eta_ewma = (1 - alpha) * self.eta_ewma
        else:
            self.failures += 1
            self.loss_ewma = (1 - alpha) * self.loss_ewma + alpha

    def record_eta(self, eta: float, alpha: float = 0.4) -> None:
        """Fold in a busy receipt's predicted-completion quote."""
        eta = max(eta, 0.0)
        self.eta_ewma = eta if self.eta_ewma == 0 \
            else (1 - alpha) * self.eta_ewma + alpha * eta

    @property
    def measured(self) -> bool:
        return (self.successes + self.failures) > 0

    def score(self, rtt_floor: float = 1e-4, loss_weight: float = 8.0) -> float:
        """Congestion/RTT score used by adaptive strategies (lower = better)."""
        rtt = self.rtt_ewma if self.rtt_ewma > 0 else rtt_floor
        return rtt * (1.0 + loss_weight * self.loss_ewma) * (1.0 + 0.25 * self.pending)


def _sync_nexthops(fib, prefix: Name, desired: Dict[int, float]) -> bool:
    """Shared body of ``Fib.sync_prefix`` / ``LinearFib.sync_prefix`` —
    one implementation so the trie and the linear oracle *cannot* diverge.

    Makes the prefix's nexthop set exactly ``desired`` (face -> cost):
    unlike ``register`` (which keeps the minimum cost ever seen — correct
    for additive announcements, wrong for a route whose path just got
    longer) it assigns costs, removes faces absent from ``desired``, and
    preserves the learned NextHop statistics of faces that stay."""
    changed = False
    for fid in [f for f in fib.nexthops(prefix) if f not in desired]:
        fib.unregister(prefix, fid)
        changed = True
    for fid, cost in desired.items():
        hop = fib.nexthops(prefix).get(fid)
        if hop is None:
            fib.register(prefix, fid, cost)
            changed = True
        elif hop.cost != cost:
            hop.cost = cost
            changed = True
    return changed


class _TrieNode:
    """A node of the compressed (radix) component trie.

    ``label`` is the component run on the edge *into* this node; ``hops``
    is non-None iff an announced prefix terminates here.
    """

    __slots__ = ("label", "children", "hops")

    def __init__(self, label: Key = ()):
        self.label: Key = label
        self.children: Dict[str, "_TrieNode"] = {}
        self.hops: Optional[Dict[int, NextHop]] = None


class Fib:
    """Longest-prefix-match forwarding table over a compressed trie.

    Public API is identical to the historical linear implementation
    (:class:`LinearFib`); only the lookup complexity changed — O(len(name))
    component comparisons instead of O(len(name) * table size).
    """

    def __init__(self) -> None:
        self._root = _TrieNode()
        # exact-match mirror of trie terminals: key -> hops (same dict object)
        self._entries: Dict[Key, Dict[int, NextHop]] = {}
        # face -> announced prefixes through it (makes remove_face O(routes))
        self._by_face: Dict[int, Set[Key]] = {}
        # key -> cost-sorted nexthop list, invalidated on any mutation of the
        # prefix's hop set; lookup() is per-packet-per-hop and the sort was
        # its dominant cost once the trie walk got cheap
        self._sorted: Dict[Key, List[NextHop]] = {}
        self.lookups = 0

    # -- trie plumbing -----------------------------------------------------
    def _insert_node(self, comps: Key) -> _TrieNode:
        node = self._root
        i = 0
        while i < len(comps):
            child = node.children.get(comps[i])
            if child is None:
                leaf = _TrieNode(comps[i:])
                node.children[comps[i]] = leaf
                return leaf
            label = child.label
            m = 0
            while (m < len(label) and i + m < len(comps)
                   and label[m] == comps[i + m]):
                m += 1
            if m < len(label):
                # split the edge at m: child keeps the head, `rest` the tail
                rest = _TrieNode(label[m:])
                rest.children = child.children
                rest.hops = child.hops
                child.label = label[:m]
                child.children = {label[m]: rest}
                child.hops = None
            node = child
            i += m
        return node

    def _prune(self, path: List[_TrieNode]) -> None:
        """Remove/merge empty nodes after a delete (path is root..leaf)."""
        for idx in range(len(path) - 1, 0, -1):
            node, parent = path[idx], path[idx - 1]
            if node.hops is not None:
                break
            if not node.children:
                del parent.children[node.label[0]]
            elif len(node.children) == 1:
                (only,) = node.children.values()
                only.label = node.label + only.label
                parent.children[node.label[0]] = only
            else:
                break

    def _walk(self, comps: Key) -> Optional[List[_TrieNode]]:
        """Exact descent to the node terminating ``comps``; None if absent."""
        node = self._root
        path = [node]
        i = 0
        while i < len(comps):
            child = node.children.get(comps[i])
            if child is None:
                return None
            label = child.label
            if comps[i:i + len(label)] != label:
                return None
            i += len(label)
            node = child
            path.append(node)
        return path if node.hops is not None else None

    # -- public API --------------------------------------------------------
    def register(self, prefix: Name, face_id: int, cost: float = 1.0) -> None:
        key = prefix.components
        hops = self._entries.get(key)
        if hops is None:
            hops = {}
            self._entries[key] = hops
            self._insert_node(key).hops = hops
        if face_id in hops:
            hops[face_id].cost = min(hops[face_id].cost, cost)
            hops[face_id].healthy = True
        else:
            hops[face_id] = NextHop(face_id=face_id, cost=cost)
        self._by_face.setdefault(face_id, set()).add(key)
        self._sorted.pop(key, None)

    def unregister(self, prefix: Name, face_id: Optional[int] = None) -> None:
        key = prefix.components
        hops = self._entries.get(key)
        if hops is None:
            return
        self._sorted.pop(key, None)
        if face_id is None:
            for fid in list(hops):
                self._by_face.get(fid, set()).discard(key)
            hops.clear()
        else:
            if hops.pop(face_id, None) is not None:
                self._by_face.get(face_id, set()).discard(key)
        if not hops:
            del self._entries[key]
            path = self._walk(key)
            if path is not None:
                path[-1].hops = None
                self._prune(path)

    def remove_face(self, face_id: int) -> None:
        """A face died (cluster left / link failure): purge every route."""
        for key in list(self._by_face.get(face_id, ())):
            self.unregister(Name(key), face_id)
        self._by_face.pop(face_id, None)

    def sync_prefix(self, prefix: Name, desired: Dict[int, float]) -> bool:
        """RIB->FIB derivation entry point: set semantics over the nexthop
        set; see :func:`_sync_nexthops` (shared with :class:`LinearFib` so
        the oracle cannot diverge).  Returns True if anything changed."""
        changed = _sync_nexthops(self, prefix, desired)
        if changed:
            # in-place cost updates bypass register/unregister
            self._sorted.pop(prefix.components, None)
        return changed

    def lookup(self, name: Name) -> Tuple[Optional[Name], List[NextHop]]:
        """Longest-prefix match; returns (matched_prefix, nexthops)."""
        self.lookups += 1
        comps = name.components
        n = len(comps)
        node = self._root
        i = 0
        best_depth = -1
        best_hops: Optional[Dict[int, NextHop]] = None
        if node.hops:
            best_depth, best_hops = 0, node.hops
        while i < n:
            child = node.children.get(comps[i])
            if child is None:
                break
            label = child.label
            ln = len(label)
            if ln > n - i:
                break
            if ln > 1:
                # label[0] already matched via the children key
                j = 1
                while j < ln and label[j] == comps[i + j]:
                    j += 1
                if j < ln:
                    break
            i += ln
            node = child
            if node.hops:
                best_depth, best_hops = i, node.hops
        if best_hops:
            key = comps[:best_depth]
            ranked = self._sorted.get(key)
            if ranked is None:
                ranked = sorted(best_hops.values(), key=lambda h: h.cost)
                self._sorted[key] = ranked
            return Name(key), ranked
        return None, []

    def prefixes(self) -> Iterable[Name]:
        return (Name(c) for c in self._entries)

    def keys(self) -> Iterable[Key]:
        """Announced prefix keys without the per-entry Name construction
        (convergence checks over 1000-node meshes scan every FIB)."""
        return self._entries.keys()

    def nexthops(self, prefix: Name) -> Dict[int, NextHop]:
        return self._entries.get(prefix.components, {})

    def nexthops_by_key(self, key: Key) -> Dict[int, NextHop]:
        return self._entries.get(key, {})

    def __len__(self) -> int:
        return len(self._entries)


class LinearFib:
    """Reference linear-scan FIB: the benchmark baseline and the obviously-
    correct property-test oracle the trie must agree with.  Lookup scans
    every announced prefix for the longest component-wise match — O(table
    size) per lookup, which is exactly what the trie exists to avoid."""

    def __init__(self) -> None:
        self._table: Dict[Key, Dict[int, NextHop]] = {}
        self.lookups = 0

    def register(self, prefix: Name, face_id: int, cost: float = 1.0) -> None:
        hops = self._table.setdefault(prefix.components, {})
        if face_id in hops:
            hops[face_id].cost = min(hops[face_id].cost, cost)
            hops[face_id].healthy = True
        else:
            hops[face_id] = NextHop(face_id=face_id, cost=cost)

    def unregister(self, prefix: Name, face_id: Optional[int] = None) -> None:
        hops = self._table.get(prefix.components)
        if hops is None:
            return
        if face_id is None:
            del self._table[prefix.components]
            return
        hops.pop(face_id, None)
        if not hops:
            del self._table[prefix.components]

    def remove_face(self, face_id: int) -> None:
        for prefix in list(self._table):
            self._table[prefix].pop(face_id, None)
            if not self._table[prefix]:
                del self._table[prefix]

    def sync_prefix(self, prefix: Name, desired: Dict[int, float]) -> bool:
        """Same shared implementation as :meth:`Fib.sync_prefix`."""
        return _sync_nexthops(self, prefix, desired)

    def lookup(self, name: Name) -> Tuple[Optional[Name], List[NextHop]]:
        self.lookups += 1
        comps = name.components
        best: Optional[Key] = None
        for key, hops in self._table.items():
            if (hops and len(key) <= len(comps) and comps[:len(key)] == key
                    and (best is None or len(key) > len(best))):
                best = key
        if best is None:
            return None, []
        return (Name(best),
                sorted(self._table[best].values(), key=lambda h: h.cost))

    def prefixes(self) -> Iterable[Name]:
        return (Name(c) for c in self._table)

    def nexthops(self, prefix: Name) -> Dict[int, NextHop]:
        return self._table.get(prefix.components, {})

    def __len__(self) -> int:
        return len(self._table)


# ---------------------------------------------------------------------------
# RIB
# ---------------------------------------------------------------------------

@dataclass
class RibRoute:
    """One learned route: a neighbor's advertisement for (prefix, origin).

    ``cost`` is the neighbor's advertised cost plus the local link cost;
    ``path`` is the advertiser chain from the origin (loop prevention);
    ``expires_at`` bounds staleness — a route that is not refreshed dies.
    ``caps`` carries the origin's capability record (chips, memory, queue
    depth) so matchmaking/strategies can see what the network advertised.
    """

    origin: str
    face_id: int
    seq: int
    cost: float
    path: Tuple[str, ...]
    expires_at: float
    caps: Optional[Dict] = None
    # origin-signed fields carried through re-advertisement unchanged
    lifetime: float = 0.0
    sig: str = ""


class Rib:
    """Routing information base: per-prefix, per-(origin, face) routes.

    The RIB holds everything the routing protocol learned; the FIB holds
    only the locally *derived* forwarding choice (:meth:`nexthops` ->
    :meth:`Fib.sync_prefix`).  Splitting the two is what lets withdrawals,
    expiry and link failure re-derive a clean FIB with no dangling faces.
    """

    def __init__(self) -> None:
        self._prefixes: Dict[Key, Dict[Tuple[str, int], RibRoute]] = {}
        # face -> prefixes with at least one route through it
        self._by_face: Dict[int, Set[Key]] = {}
        # lower bound on the earliest route expiry: expire() is called every
        # heartbeat on every agent, and almost always has nothing to do —
        # the bound makes that case O(1) instead of O(routes).  Removals may
        # leave the bound stale-low, which only costs one wasted scan.
        self._expiry_bound = float("inf")

    # -- mutation ----------------------------------------------------------
    def upsert(self, prefix: Name, route: RibRoute) -> bool:
        """Insert/replace the (origin, face) route; True if it changed the
        derivable state (cost/seq/caps/path — not a pure lifetime refresh
        ... which still extends ``expires_at``)."""
        key = prefix.components
        routes = self._prefixes.setdefault(key, {})
        slot = (route.origin, route.face_id)
        prior = routes.get(slot)
        routes[slot] = route
        self._by_face.setdefault(route.face_id, set()).add(key)
        if route.expires_at < self._expiry_bound:
            self._expiry_bound = route.expires_at
        return (prior is None or prior.cost != route.cost
                or prior.seq != route.seq or prior.path != route.path
                or prior.caps != route.caps)

    def remove(self, prefix: Name, *, origin: Optional[str] = None,
               face_id: Optional[int] = None) -> bool:
        """Remove routes for a prefix, filtered by origin and/or face."""
        key = prefix.components
        routes = self._prefixes.get(key)
        if routes is None:
            return False
        doomed = [s for s in routes
                  if (origin is None or s[0] == origin)
                  and (face_id is None or s[1] == face_id)]
        for s in doomed:
            del routes[s]
        if not routes:
            del self._prefixes[key]
        self._reindex_faces(key, {s[1] for s in doomed})
        return bool(doomed)

    def remove_face(self, face_id: int) -> List[Key]:
        """Link died: drop every route through it; returns affected keys."""
        affected = []
        for key in list(self._by_face.get(face_id, ())):
            routes = self._prefixes.get(key, {})
            doomed = [s for s in routes if s[1] == face_id]
            for s in doomed:
                del routes[s]
            if not routes:
                self._prefixes.pop(key, None)
            affected.append(key)
        self._by_face.pop(face_id, None)
        return affected

    def expire(self, now: float) -> List[Key]:
        """Drop lifetime-expired routes; returns affected prefix keys."""
        if now < self._expiry_bound:
            return []            # nothing can be due yet: O(1) fast path
        affected = []
        soonest = float("inf")
        for key in list(self._prefixes):
            routes = self._prefixes[key]
            dead = [s for s, r in routes.items() if r.expires_at <= now]
            if not dead:
                for r in routes.values():
                    if r.expires_at < soonest:
                        soonest = r.expires_at
                continue
            faces = set()
            for s in dead:
                faces.add(s[1])
                del routes[s]
            for r in routes.values():
                if r.expires_at < soonest:
                    soonest = r.expires_at
            if not routes:
                del self._prefixes[key]
            self._reindex_faces(key, faces)
            affected.append(key)
        self._expiry_bound = soonest
        return affected

    def extend_face(self, face_id: int, now: float) -> int:
        """Face-scoped keepalive refresh: the neighbor behind ``face_id``
        says every route it advertised to us is still good, so push each
        such route's expiry out by its own lifetime.  Hop-by-hop soft
        state: a route survives exactly as long as every hop of its
        advertiser chain keeps refreshing its downstream — no flooding.
        Returns the number of routes extended."""
        n = 0
        for key in self._by_face.get(face_id, ()):
            for (_, fid), r in self._prefixes.get(key, {}).items():
                if fid == face_id:
                    fresh = now + r.lifetime
                    if fresh > r.expires_at:
                        r.expires_at = fresh
                        n += 1
        return n

    def count_face(self, face_id: int) -> int:
        """Number of (prefix, origin) routes learned over ``face_id`` —
        compared against the advertiser's keepalive count digest to detect
        advertisements a lossy or flapping link silently ate."""
        n = 0
        for key in self._by_face.get(face_id, ()):
            for (_, fid) in self._prefixes.get(key, {}):
                if fid == face_id:
                    n += 1
        return n

    def _reindex_faces(self, key: Key, candidate_faces: Set[int]) -> None:
        still = {s[1] for s in self._prefixes.get(key, {})}
        for fid in candidate_faces:
            if fid not in still:
                bucket = self._by_face.get(fid)
                if bucket is not None:
                    bucket.discard(key)
                    if not bucket:
                        del self._by_face[fid]

    # -- queries -----------------------------------------------------------
    def routes(self, prefix: Name) -> Dict[Tuple[str, int], RibRoute]:
        return self._prefixes.get(prefix.components, {})

    def origins(self, prefix: Name) -> List[str]:
        return sorted({s[0] for s in self._prefixes.get(prefix.components, {})})

    def best(self, prefix: Name, origin: str) -> Optional[RibRoute]:
        """Lowest-cost route toward one origin (face id breaks ties)."""
        cands = [r for (o, _), r in
                 self._prefixes.get(prefix.components, {}).items()
                 if o == origin]
        if not cands:
            return None
        return min(cands, key=lambda r: (r.cost, r.face_id))

    def nexthops(self, prefix: Name, *, slack: float = 1.0) -> Dict[int, float]:
        """Derive the FIB nexthop set: per-face minimum cost over every
        origin, keeping faces within ``slack`` of the overall best — the
        detour routes strategies fail over to before re-convergence."""
        best_per_face: Dict[int, float] = {}
        for route in self._prefixes.get(prefix.components, {}).values():
            cur = best_per_face.get(route.face_id)
            if cur is None or route.cost < cur:
                best_per_face[route.face_id] = route.cost
        if not best_per_face:
            return {}
        best = min(best_per_face.values())
        return {f: c for f, c in best_per_face.items() if c <= best + slack}

    def capabilities(self, prefix: Name) -> Dict[str, Dict]:
        """Advertised capability record per origin (best route's copy)."""
        out: Dict[str, Dict] = {}
        for origin in self.origins(prefix):
            r = self.best(prefix, origin)
            if r is not None and r.caps is not None:
                out[origin] = r.caps
        return out

    def prefixes(self) -> Iterable[Name]:
        return (Name(k) for k in self._prefixes)

    def next_expiry(self) -> Optional[float]:
        times = [r.expires_at for routes in self._prefixes.values()
                 for r in routes.values()]
        return min(times) if times else None

    def __len__(self) -> int:
        return len(self._prefixes)


# ---------------------------------------------------------------------------
# PIT
# ---------------------------------------------------------------------------

@dataclass
class PitEntry:
    name: Name
    expiry: float
    in_faces: Set[int] = field(default_factory=set)     # downstream consumers
    out_faces: Set[int] = field(default_factory=set)    # upstreams tried
    nonces: Set[int] = field(default_factory=set)
    sent_at: Dict[int, float] = field(default_factory=dict)  # face -> send time
    resolved: Set[int] = field(default_factory=set)     # upstreams with a recorded outcome
    retransmissions: int = 0


class Pit:
    """Pending Interest Table with aggregation and nonce loop-suppression.

    Satisfaction walks the *prefixes of the Data name* (a Data satisfies an
    entry iff the entry's name is a prefix of, or equal to, the Data name),
    so it is O(len(name)) hash probes.  Expiry is a lazy min-heap, so a
    forwarder ticking the PIT per packet pays O(expired) not O(pending).
    """

    # compact the expiry heap when it holds > _COMPACT_FACTOR x more
    # records than live entries (and is big enough to matter): satisfied /
    # retransmission-extended entries leave stale tombstones behind, and a
    # long-lived forwarder under churn would otherwise grow the heap
    # without bound even though its PIT stays small.
    _COMPACT_MIN = 64
    _COMPACT_FACTOR = 4

    def __init__(self) -> None:
        self._table: Dict[Key, PitEntry] = {}
        self._expiry_heap: List[Tuple[float, int, Key]] = []
        self._seq = itertools.count()
        self.compactions = 0

    def _maybe_compact(self) -> None:
        heap = self._expiry_heap
        if (len(heap) > self._COMPACT_MIN
                and len(heap) > self._COMPACT_FACTOR * (len(self._table) + 1)):
            self._expiry_heap = [(e.expiry, next(self._seq), k)
                                 for k, e in self._table.items()]
            heapq.heapify(self._expiry_heap)
            self.compactions += 1

    def insert(self, interest: Interest, in_face: int, now: float
               ) -> Tuple[PitEntry, bool, bool]:
        """Record an incoming Interest.

        Returns (entry, is_new, is_duplicate_nonce).  ``is_new`` means no
        pending entry existed (caller must forward upstream); aggregation
        happens when an entry exists with a different nonce.
        """
        key = interest.name.components
        entry = self._table.get(key)
        if entry is None:
            entry = PitEntry(name=interest.name, expiry=now + interest.lifetime)
            entry.in_faces.add(in_face)
            entry.nonces.add(interest.nonce)
            self._table[key] = entry
            heapq.heappush(self._expiry_heap, (entry.expiry, next(self._seq), key))
            return entry, True, False
        if interest.nonce in entry.nonces:
            return entry, False, True          # looped duplicate: drop
        entry.nonces.add(interest.nonce)
        entry.in_faces.add(in_face)
        extended = now + interest.lifetime
        if extended > entry.expiry:
            entry.expiry = extended
            heapq.heappush(self._expiry_heap, (extended, next(self._seq), key))
            self._maybe_compact()
        return entry, False, False

    def satisfy(self, name: Name) -> List[PitEntry]:
        """Data arrived: pop every entry whose name it satisfies (exact or
        the Data name extends the Interest name)."""
        out = []
        comps = name.components
        for i in range(len(comps) + 1):
            entry = self._table.pop(comps[:i], None)
            if entry is not None:
                out.append(entry)
        if out:
            self._maybe_compact()
        return out

    def get(self, name: Name) -> Optional[PitEntry]:
        return self._table.get(name.components)

    def next_expiry(self) -> Optional[float]:
        """Earliest live entry expiry, or None — lets a forwarder schedule
        an expiry tick so timeouts are recorded even while quiescent."""
        heap = self._expiry_heap
        while heap:
            t, _, key = heap[0]
            entry = self._table.get(key)
            if entry is None or entry.expiry > t:
                heapq.heappop(heap)     # satisfied or extended: stale record
                continue
            return t
        return None

    def expires_by(self, now: float) -> bool:
        """Cheap guard: could anything be expired at ``now``?  Lets the
        per-packet expiry hook skip the call-and-allocate path entirely."""
        heap = self._expiry_heap
        return bool(heap) and heap[0][0] <= now

    def expire(self, now: float) -> List[PitEntry]:
        """Pop expired entries (drives retransmission / failover upstream)."""
        dead: List[PitEntry] = []
        heap = self._expiry_heap
        while heap and heap[0][0] <= now:
            _, _, key = heapq.heappop(heap)
            entry = self._table.get(key)
            # entry may be gone (satisfied) or extended (a fresher heap
            # record exists for it) — lazy deletion skips both cases.
            if entry is not None and entry.expiry <= now:
                dead.append(self._table.pop(key))
        return dead

    def __len__(self) -> int:
        return len(self._table)


# ---------------------------------------------------------------------------
# Content Store
# ---------------------------------------------------------------------------

class ContentStore:
    """LRU cache of Data packets; doubles as the paper's result cache.

    A prefix hash-index (every prefix of every stored name -> stored keys)
    turns ``can_be_prefix`` matching and prefix invalidation into O(1)
    index probes instead of full-store scans.  Among multiple prefix
    candidates the lexicographically-smallest *satisfying* entry wins,
    which is deterministic and — unlike the old first-in-LRU-order scan —
    never misses because a stale entry shadowed a fresh one.

    Eviction is budgeted two ways: ``capacity`` bounds the entry *count*
    and ``capacity_bytes`` (optional) bounds the summed content size.
    Without the byte budget a 32 MiB bulk segment and a 100 B compute
    receipt each cost one LRU slot, so one windowed object fetch could
    evict thousands of cached results; with it, bulk data competes for
    bytes, not slots.
    """

    def __init__(self, capacity: int = 4096,
                 capacity_bytes: Optional[int] = None,
                 prefix_stats_depth: int = 3,
                 prefix_stats_capacity: int = 512) -> None:
        self.capacity = capacity
        self.capacity_bytes = capacity_bytes
        self.bytes_stored = 0
        self._store: "OrderedDict[Key, Data]" = OrderedDict()
        self._prefix_index: Dict[Key, Set[Key]] = {}
        # per-prefix hit/miss accounting (keys truncated to
        # ``prefix_stats_depth`` components — dataset granularity for the
        # default /lidc/data/<name> layout), LRU-bounded like the name
        # caches so distinct-name churn cannot grow it without bound.
        # The global ``hit_rate`` scalar is unchanged.
        self.prefix_stats_depth = prefix_stats_depth
        self.prefix_stats_capacity = prefix_stats_capacity
        self.prefix_stats_evictions = 0
        self._pstats: "OrderedDict[Key, List[int]]" = OrderedDict()
        # keys inserted but not yet folded into the prefix index.  Building
        # the len+1 prefix slices costs ~40µs per insert and most traffic
        # (exact-match compute results, routing scenarios) never issues a
        # prefix query — so indexing is deferred until the first
        # ``can_be_prefix`` miss or prefix eviction actually needs it.
        self._unindexed: Dict[Key, None] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -- index plumbing ----------------------------------------------------
    def _index_pending(self) -> None:
        index = self._prefix_index
        for key in self._unindexed:
            for i in range(len(key) + 1):
                index.setdefault(key[:i], set()).add(key)
        self._unindexed.clear()

    def _unindex(self, key: Key) -> None:
        if key in self._unindexed:
            del self._unindexed[key]
            return
        for i in range(len(key) + 1):
            bucket = self._prefix_index.get(key[:i])
            if bucket is not None:
                bucket.discard(key)
                if not bucket:
                    del self._prefix_index[key[:i]]

    def _remove(self, key: Key) -> None:
        self.bytes_stored -= len(self._store[key].content)
        del self._store[key]
        self._unindex(key)

    # -- public API --------------------------------------------------------
    def insert(self, data: Data) -> None:
        size = len(data.content)
        key = data.name.components
        if self.capacity_bytes is not None and size > self.capacity_bytes:
            # admission control: never flush the cache for one object — but
            # a stale smaller entry under the same name must not keep
            # answering for content we just declined to cache
            if key in self._store:
                self._remove(key)
            return
        prior = self._store.get(key)
        if prior is not None:
            self.bytes_stored -= len(prior.content)
            self._store.move_to_end(key)
        else:
            self._unindexed[key] = None
        self._store[key] = data
        self.bytes_stored += size
        while len(self._store) > self.capacity or (
                self.capacity_bytes is not None
                and self.bytes_stored > self.capacity_bytes):
            oldest, doomed = self._store.popitem(last=False)
            self.bytes_stored -= len(doomed.content)
            self._unindex(oldest)
            self.evictions += 1

    def match(self, interest: Interest, now: float) -> Optional[Data]:
        """Find a cached Data satisfying the Interest."""
        key = interest.name.components
        hit: Optional[Data] = None
        exact = self._store.get(key)
        if exact is not None and not (interest.must_be_fresh
                                      and not exact.is_fresh(now)):
            hit = exact
        elif interest.can_be_prefix:
            if self._unindexed:
                self._index_pending()
            for k in sorted(self._prefix_index.get(key, ())):
                d = self._store[k]
                if interest.must_be_fresh and not d.is_fresh(now):
                    continue
                hit = d
                break
        pk = key[:self.prefix_stats_depth]
        rec = self._pstats.get(pk)
        if rec is None:
            rec = [0, 0]
            self._pstats[pk] = rec
            if len(self._pstats) > self.prefix_stats_capacity:
                self._pstats.popitem(last=False)
                self.prefix_stats_evictions += 1
        else:
            self._pstats.move_to_end(pk)
        if hit is None:
            self.misses += 1
            rec[1] += 1
            return None
        self.hits += 1
        rec[0] += 1
        self._store.move_to_end(hit.name.components)
        return hit

    def evict_prefix(self, prefix: Name) -> int:
        """Invalidate everything under a prefix (e.g. checkpoint superseded)."""
        if self._unindexed:
            self._index_pending()
        doomed = list(self._prefix_index.get(prefix.components, ()))
        for k in doomed:
            self._remove(k)
        return len(doomed)

    def __len__(self) -> int:
        return len(self._store)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def hit_rate_for(self, prefix: Name) -> float:
        """Hit rate over matches whose Interest fell under ``prefix``
        (truncated to the tracked depth); 0.0 when never matched."""
        rec = self._pstats.get(prefix.components[:self.prefix_stats_depth])
        if rec is None or rec[0] + rec[1] == 0:
            return 0.0
        return rec[0] / (rec[0] + rec[1])

    def prefix_hit_rates(self) -> Dict[str, float]:
        """Per-prefix hit rates (the replication policy / bench surface);
        the global scalar :attr:`hit_rate` is unchanged."""
        return {str(Name(k)): h / (h + m)
                for k, (h, m) in self._pstats.items() if h + m}

    def stats(self) -> Dict[str, float]:
        return {"entries": len(self._store), "bytes_stored": self.bytes_stored,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "hit_rate": self.hit_rate,
                "prefix_stats_entries": len(self._pstats),
                "prefix_stats_evictions": self.prefix_stats_evictions}
