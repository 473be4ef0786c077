"""Per-prefix demand telemetry — the input side of proactive replication.

A :class:`DemandTracker` attaches to a forwarder (``node.demand``) and
counts Interests per *object name* with exponential decay on the virtual
clock, so "hot" means *recently* hot — a dataset nobody has asked about
for a few half-lives reads as cold no matter how popular it once was.

Two bounds keep a long-lived forwarder's demand state O(1):

* **LRU capacity** — the tracker holds at most ``capacity`` distinct
  keys; observing a new key past the bound evicts the least-recently
  observed one (the same discipline as the name caches).
  10k distinct hot prefixes churning through a forwarder cannot grow
  state without bound; ``stats()`` exports size/capacity/evictions.
* **Key depth** — names are truncated to ``max_depth`` components after
  stripping the segment-pipeline suffixes (``seg=i`` / ``manifest``), so
  one object fetched as 64 segments is *one* demand key, not 65.

Decay is computed lazily from ``(value, stamp)`` pairs — no periodic
sweep event exists, so an idle tracker costs nothing and replay traces
are identical across event engines.

The port's copy of ``repro/core/demand.py``: the same logic, its imports
pointing inside ``repro_torch``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterable, List, Set, Tuple

from .names import Name

__all__ = ["DemandTracker"]

Key = Tuple[str, ...]

# suffix components that address *parts* of an object, not the object:
# demand for any of them is demand for the base name
_PART_SUFFIXES = ("manifest",)


def _strip_parts(comps: Key) -> Key:
    while comps and (comps[-1] in _PART_SUFFIXES
                     or comps[-1].startswith("seg=")):
        comps = comps[:-1]
    return comps


class DemandTracker:
    """Bounded, decaying per-object Interest counter.

    ``observe`` folds one Interest into the tracked rate; ``rate`` reads
    the decayed value; ``hot`` returns every key at or above a threshold,
    deterministically ordered (rate descending, then name) — the scan the
    replication policy runs each tick.  ``ignore_faces`` excludes a
    manager's own transfer Interests so a replication pull does not read
    as fresh reader demand for the object it is pulling.
    """

    def __init__(self, *, capacity: int = 512, half_life: float = 2.0,
                 prefix: str = "/lidc/data", max_depth: int = 6,
                 exclude: Iterable[str] = ()):
        self.capacity = max(1, int(capacity))
        self.half_life = max(1e-9, float(half_life))
        self.prefix_key: Key = Name.parse(prefix).components
        self.max_depth = max(len(self.prefix_key) + 1, int(max_depth))
        # sub-namespaces that must never read as replication demand:
        # derived/ephemeral objects another plane owns (compute results,
        # live serving-session state) — see ReplicationPolicy.exclude
        self.exclude_keys: Tuple[Key, ...] = tuple(
            Name.parse(p).components for p in exclude)
        self.ignore_faces: Set[int] = set()
        # key -> [decayed count at `stamp`, stamp]
        self._table: "OrderedDict[Key, List[float]]" = OrderedDict()
        self.observations = 0
        self.evictions = 0

    # ------------------------------------------------------------- updates
    def observe(self, name: Name, now: float, in_face: int = -1) -> None:
        comps = name.components
        plen = len(self.prefix_key)
        if comps[:plen] != self.prefix_key or len(comps) <= plen:
            return
        if in_face in self.ignore_faces:
            return
        for ex in self.exclude_keys:
            if comps[:len(ex)] == ex:
                return
        # count *readers*, not packets: a read is opened by a manifest,
        # bare-name, or first-segment Interest, each counting one toward
        # the base object; the later segment Interests are the same read
        # and are skipped entirely.  Counting BOTH openers matters at an
        # aggregation point — a downstream cache holding just the (tiny,
        # fresh) manifest would otherwise absorb the counting Interest
        # while every data segment still flows through, silently
        # undercounting exactly the hottest objects.  A fully cold read
        # counts at most twice (manifest + seg=0): a bounded, uniform
        # inflation, where the blind spot was an unbounded deflation.
        key = comps
        while key and (key[-1] in _PART_SUFFIXES
                       or key[-1].startswith("seg=")):
            if key[-1].startswith("seg=") and key[-1] != "seg=0":
                return
            key = key[:-1]
        key = key[:self.max_depth]
        if len(key) <= plen:
            return
        self.observations += 1
        rec = self._table.get(key)
        if rec is None:
            self._table[key] = [1.0, now]
            if len(self._table) > self.capacity:
                self._table.popitem(last=False)
                self.evictions += 1
            return
        rec[0] = rec[0] * 0.5 ** ((now - rec[1]) / self.half_life) + 1.0
        rec[1] = now
        self._table.move_to_end(key)

    # ------------------------------------------------------------- queries
    def rate(self, key_or_name, now: float) -> float:
        """Decayed demand (Interests per half-life window) for one key."""
        key = (key_or_name.components if isinstance(key_or_name, Name)
               else tuple(key_or_name))
        rec = self._table.get(_strip_parts(key)[:self.max_depth])
        if rec is None:
            return 0.0
        return rec[0] * 0.5 ** ((now - rec[1]) / self.half_life)

    def hot(self, now: float, threshold: float) -> List[Tuple[Key, float]]:
        """Keys whose decayed demand is >= ``threshold``, hottest first;
        ties broken by name so the scan order is replay-deterministic."""
        out = []
        for key, rec in self._table.items():
            r = rec[0] * 0.5 ** ((now - rec[1]) / self.half_life)
            if r >= threshold:
                out.append((key, r))
        out.sort(key=lambda kr: (-kr[1], kr[0]))
        return out

    def keys(self) -> Iterable[Key]:
        return self._table.keys()

    def stats(self) -> Dict[str, float]:
        return {"entries": len(self._table), "capacity": self.capacity,
                "observations": self.observations,
                "evictions": self.evictions}

    def __len__(self) -> int:
        return len(self._table)
