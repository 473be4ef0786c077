"""Hierarchical names and the semantic job-name codec.

LIDC expresses *everything* — computations, datasets, checkpoints, status
queries — as hierarchical names (paper §III.B).  A compute request name
carries the application, its parameters and its resource requirements,
e.g.::

    /lidc/compute/app=train&arch=qwen3-1.7b&shape=train_4k&chips=256&steps=100

This module implements:

* :class:`Name` — an immutable hierarchical name with longest-prefix-match
  helpers (the unit the FIB routes on).
* :func:`encode_job` / :func:`parse_job` — the semantic codec between a
  key-value job description and the final name component (the paper's
  ``mem=4&cpu=6&app=BLAST`` convention).
* :func:`canonical_job_name` — deterministic ordering of the key-value
  pairs so that *identical requests produce identical names*, which is what
  makes Content-Store result caching (paper §VII) sound.

The port's copy of ``repro/core/names.py``: the same logic, its imports
pointing inside ``repro_torch``.
"""

from __future__ import annotations

import re
import sys
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

__all__ = [
    "Name",
    "encode_job",
    "parse_job",
    "canonical_job_name",
    "batch_job_name",
    "batch_fields_of",
    "job_fields_of",
    "serve_session_name",
    "serve_fields_of",
    "configure_name_caches",
    "name_cache_stats",
    "COMPUTE_PREFIX",
    "DATA_PREFIX",
    "STATUS_PREFIX",
    "CAPABILITY_PREFIX",
    "SERVE_PREFIX",
    "BATCH_PREFIX",
]

# Well-known prefixes, mirroring the paper's /ndn/k8s/{compute,data,status}.
COMPUTE_PREFIX = "/lidc/compute"
DATA_PREFIX = "/lidc/data"
STATUS_PREFIX = "/lidc/status"
# Capability announcements (cluster -> overlay); the analog of a cluster
# exposing a named K8s service endpoint to the NDN network.
CAPABILITY_PREFIX = "/lidc/cap"
# Inference sessions: /lidc/serve/<model>/<k=v&...> — a serving-plane
# request is an ordinary compute Interest under a model-rooted prefix, so
# LPM places a session on *any* cluster advertising that model.
SERVE_PREFIX = "/lidc/serve"
# Batched job submission: one /lidc/jobs/batch/<app>/<k=v&lo=&hi=> Interest
# carries a homogeneous [lo, hi) part range, so a 10k-task map pays per-job
# signing/validation/admission once per batch, not once per task.  Clusters
# advertise /lidc/jobs/batch/<app> alongside their compute prefixes.
BATCH_PREFIX = "/lidc/jobs/batch"

_COMPONENT_RE = re.compile(r"^[A-Za-z0-9_.,=&\-+%:]+$")

# Parsed-name memo: routing agents, codecs and benchmarks re-parse the same
# handful of uri strings per packet / per advertisement, so cache the Name
# (components interned so equal names share component strings process-wide).
# The cache is a true LRU (hits refresh recency, eviction drops the oldest
# entry) so a 10k-task map minting 10k+ unique `part=i` names churns the
# cold tail without ever evicting the hot routing/control names — and the
# footprint stays bounded by the capacity, not the workload.  Names are
# immutable, so sharing instances is safe.
_PARSE_CACHE: "OrderedDict[str, Name]" = OrderedDict()
_PARSE_CACHE_MAX = 65536
# eviction counters: the memory-bound regression test (and ops curiosity)
# can tell "cache big enough" apart from "cache churning"
_CACHE_EVICTIONS = {"parse": 0, "job": 0}


def configure_name_caches(*, parse_capacity: Optional[int] = None,
                          job_capacity: Optional[int] = None) -> None:
    """Resize the parse/job LRU caches (None leaves a capacity unchanged).

    Shrinking evicts least-recently-used entries immediately, so the
    memory bound holds from the moment of the call."""
    global _PARSE_CACHE_MAX, _JOB_CACHE_MAX
    if parse_capacity is not None:
        _PARSE_CACHE_MAX = max(1, int(parse_capacity))
        while len(_PARSE_CACHE) > _PARSE_CACHE_MAX:
            _PARSE_CACHE.popitem(last=False)
            _CACHE_EVICTIONS["parse"] += 1
    if job_capacity is not None:
        _JOB_CACHE_MAX = max(1, int(job_capacity))
        while len(_JOB_CACHE) > _JOB_CACHE_MAX:
            _JOB_CACHE.popitem(last=False)
            _CACHE_EVICTIONS["job"] += 1


def name_cache_stats() -> Dict[str, int]:
    """Live size/capacity/eviction counters for both name caches."""
    return {"parse_size": len(_PARSE_CACHE),
            "parse_capacity": _PARSE_CACHE_MAX,
            "parse_evictions": _CACHE_EVICTIONS["parse"],
            "job_size": len(_JOB_CACHE),
            "job_capacity": _JOB_CACHE_MAX,
            "job_evictions": _CACHE_EVICTIONS["job"]}


@dataclass(frozen=True)
class Name:
    """An immutable hierarchical name: ``/a/b/c``.

    Components are stored as a tuple of strings.  Comparison, hashing and
    prefix tests are all component-wise (never substring-wise), matching NDN
    semantics: ``/lidc/comp`` is *not* a prefix of ``/lidc/compute``.

    ``__str__`` and ``__hash__`` are computed once and cached: names are
    immutable and both sit on the per-packet hot path (the segment pipeline
    stringifies and hashes every ``seg=i`` name it forwards or stores).
    """

    components: Tuple[str, ...]
    # lazily-computed caches; excluded from equality so Name(('a',)) built
    # anywhere compares (and hashes) identically whether or not it has been
    # stringified yet
    _str: Optional[str] = field(default=None, init=False, repr=False,
                                compare=False)
    _hash: Optional[int] = field(default=None, init=False, repr=False,
                                 compare=False)

    # -- construction ------------------------------------------------------
    @staticmethod
    def parse(uri: str) -> "Name":
        raw = uri
        cached = _PARSE_CACHE.get(raw)
        if cached is not None:
            _PARSE_CACHE.move_to_end(raw)
            return cached
        uri = uri.strip()
        if not uri.startswith("/"):
            raise ValueError(f"name must start with '/': {uri!r}")
        parts = tuple(sys.intern(p) for p in uri.split("/") if p != "")
        for p in parts:
            if not _COMPONENT_RE.match(p):
                raise ValueError(f"illegal name component {p!r} in {uri!r}")
        name = Name(parts)
        while len(_PARSE_CACHE) >= _PARSE_CACHE_MAX:
            _PARSE_CACHE.popitem(last=False)
            _CACHE_EVICTIONS["parse"] += 1
        _PARSE_CACHE[raw] = name
        return name

    @staticmethod
    def of(*components: str) -> "Name":
        out: list[str] = []
        for c in components:
            out.extend(p for p in str(c).split("/") if p)
        return Name(tuple(out))

    # -- algebra -----------------------------------------------------------
    def append(self, *components: str) -> "Name":
        # hot path (called per segment per packet): extend the existing
        # component tuple directly instead of round-tripping through
        # str(self) + re-split + re-validation
        return Name(self.components + tuple(
            p for c in components for p in str(c).split("/") if p))

    def __truediv__(self, component: str) -> "Name":
        return self.append(component)

    def is_prefix_of(self, other: "Name") -> bool:
        n = len(self.components)
        return n <= len(other.components) and other.components[:n] == self.components

    def prefixes(self) -> Iterable["Name"]:
        """All prefixes of this name, longest first (for LPM walks)."""
        for i in range(len(self.components), 0, -1):
            yield Name(self.components[:i])

    def __len__(self) -> int:
        return len(self.components)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return Name(self.components[i])
        return self.components[i]

    def __str__(self) -> str:
        s = self._str
        if s is None:
            s = "/" + "/".join(self.components)
            object.__setattr__(self, "_str", s)
        return s

    def __hash__(self) -> int:
        h = self._hash
        if h is None:
            h = hash(self.components)
            object.__setattr__(self, "_hash", h)
        return h

    def __repr__(self) -> str:
        return f"Name({str(self)!r})"


# ---------------------------------------------------------------------------
# Semantic job codec (the `mem=4&cpu=6&app=BLAST` convention, paper §III.C).
# ---------------------------------------------------------------------------

_JOB_KEY_RE = re.compile(r"^[A-Za-z0-9_.\-]+$")

# component-string -> parsed field dict.  Strategies and gateways invert the
# same job component on every hop of every packet; parsing it once and
# handing out shallow copies keeps the codec off the per-hop profile.
# Same bounded-LRU discipline as _PARSE_CACHE (see configure_name_caches).
_JOB_CACHE: "OrderedDict[str, Dict[str, str]]" = OrderedDict()
_JOB_CACHE_MAX = 16384


def _encode_value(v: Any) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


def encode_job(fields: Mapping[str, Any], *, canonical: bool = True) -> str:
    """Encode a key-value job description into a single name component.

    ``canonical=True`` sorts keys so identical requests yield identical
    names (required for Content-Store result caching to hit).
    """
    items = fields.items()
    if canonical:
        items = sorted(items)
    parts = []
    for k, v in items:
        if not _JOB_KEY_RE.match(k):
            raise ValueError(f"illegal job field key {k!r}")
        parts.append(f"{k}={_encode_value(v)}")
    return "&".join(parts)


def parse_job(component: str) -> Dict[str, str]:
    """Parse ``k=v&k=v`` back into a dict. Raises on malformed input."""
    cached = _JOB_CACHE.get(component)
    if cached is not None:
        _JOB_CACHE.move_to_end(component)
        return dict(cached)     # callers mutate the result; hand out copies
    out: Dict[str, str] = {}
    if not component:
        return out
    for kv in component.split("&"):
        if "=" not in kv:
            raise ValueError(f"malformed job field {kv!r} (expected k=v)")
        k, v = kv.split("=", 1)
        if k in out:
            raise ValueError(f"duplicate job field {k!r}")
        out[k] = v
    while len(_JOB_CACHE) >= _JOB_CACHE_MAX:
        _JOB_CACHE.popitem(last=False)
        _CACHE_EVICTIONS["job"] += 1
    _JOB_CACHE[component] = out
    return dict(out)


def canonical_job_name(fields: Mapping[str, Any], prefix: str = COMPUTE_PREFIX) -> Name:
    """Build the full, canonical compute name for a job description.

    The name is *hierarchical* so that NDN longest-prefix-match can route on
    it: well-known fields become components, everything else is a trailing
    canonical ``k=v&...`` component (the paper's flat convention)::

        /lidc/compute/<app>[/<arch>[/<shape>]]/[k=v&k=v...]

    e.g. ``/lidc/compute/train/qwen3-1.7b/train_4k/chips=256&steps=100`` or
    the paper's own example as ``/lidc/compute/blast/app_db=HUMAN&cpu=6&mem=4``.
    A cluster may announce the generic ``/lidc/compute`` or a refined prefix
    like ``/lidc/compute/train/qwen3-1.7b`` — LPM prefers the refined route.
    """
    f = dict(fields)
    if "app" not in f:
        raise ValueError("job description requires an 'app' field")
    name = Name.parse(prefix).append(str(f.pop("app")))
    arch = f.pop("arch", None)
    shape = f.pop("shape", None)
    if arch is not None:
        name = name.append(str(arch))
        if shape is not None:
            name = name.append(str(shape))
    elif shape is not None:
        f["shape"] = shape  # shape without arch stays in the kv tail
    if f:
        name = name.append(encode_job(f, canonical=True))
    return name


def batch_job_name(fields: Mapping[str, Any], lo: int, hi: int) -> Name:
    """Build the canonical name of a *batched* submission::

        /lidc/jobs/batch/<app>/<canonical k=v tail incl. lo= & hi=>

    ``fields`` is the member template (everything but ``part``); the
    gateway derives member ``part=i`` specs for i in [lo, hi).  Because
    members are homogeneous, one batch Interest replaces hi-lo compute
    Interests — signing, validation, matchmaking and the receipt are all
    paid once per batch."""
    f = dict(fields)
    if "app" not in f:
        raise ValueError("batch description requires an 'app' field")
    if "lo" in f or "hi" in f or "part" in f:
        raise ValueError("lo=/hi=/part= are batch-range fields, not "
                         "template fields")
    lo, hi = int(lo), int(hi)
    if not 0 <= lo < hi:
        raise ValueError(f"batch range must satisfy 0 <= lo < hi: [{lo},{hi})")
    app = str(f.pop("app"))
    f["lo"], f["hi"] = lo, hi
    return Name.parse(BATCH_PREFIX).append(app, encode_job(f, canonical=True))


def batch_fields_of(name: Name
                    ) -> Optional[Tuple[Dict[str, str], int, int]]:
    """Invert :func:`batch_job_name` into (template fields incl. ``app``,
    lo, hi); None if the name is not a well-formed batch name."""
    base = Name.parse(BATCH_PREFIX)
    if not base.is_prefix_of(name) or len(name) != len(base) + 2:
        return None
    app, tail = name.components[len(base)], name.components[len(base) + 1]
    if "=" not in tail:
        return None
    try:
        fields = parse_job(tail)
        lo, hi = int(fields.pop("lo")), int(fields.pop("hi"))
    except (KeyError, ValueError):
        return None
    if not 0 <= lo < hi or "part" in fields:
        return None
    fields["app"] = app
    return fields, lo, hi


def serve_session_name(model: str, fields: Mapping[str, Any]) -> Name:
    """Build the canonical session name for an inference request::

        /lidc/serve/<model>/<canonical k=v tail>

    e.g. ``/lidc/serve/qwen3-1.7b/max_new=32&p=ab12&ptoks=160&sid=s-7``.
    The model is the routing unit: clusters advertise
    ``/lidc/serve/<model>`` per served model, so the session lands on any
    cluster with the weights — location independence for inference.  The
    key-value tail (session id, named prompt, decode budget, priority) is
    canonically ordered like every other job name.
    """
    f = {k: v for k, v in fields.items() if k not in ("app", "arch")}
    name = Name.parse(SERVE_PREFIX).append(str(model))
    if f:
        name = name.append(encode_job(f, canonical=True))
    return name


def serve_fields_of(name: Name) -> Optional[Dict[str, str]]:
    """Invert :func:`serve_session_name` into gateway job fields
    (``app="serve"``, ``arch=<model>`` + the k=v tail); None if the name
    is not a serve-session name."""
    base = Name.parse(SERVE_PREFIX)
    if not base.is_prefix_of(name) or len(name) <= len(base):
        return None
    rest = list(name.components[len(base):])
    fields: Dict[str, str] = {}
    if rest and "=" in rest[-1]:
        try:
            fields.update(parse_job(rest.pop()))
        except ValueError:
            return None         # malformed tail -> gateway rejects, not crashes
    if len(rest) != 1:
        return None
    fields["app"] = "serve"
    fields["arch"] = rest[0]
    return fields


def job_fields_of(name: Name) -> Optional[Dict[str, str]]:
    """Invert :func:`canonical_job_name`; None if not a compute name."""
    comp = Name.parse(COMPUTE_PREFIX)
    if not comp.is_prefix_of(name) or len(name) <= len(comp):
        return None
    rest = list(name.components[len(comp):])
    fields: Dict[str, str] = {}
    if rest and "=" in rest[-1]:
        fields.update(parse_job(rest.pop()))
    positional = ["app", "arch", "shape"]
    if len(rest) > len(positional):
        return None
    for key, value in zip(positional, rest):
        fields[key] = value
    if "app" not in fields:
        return None
    return fields
