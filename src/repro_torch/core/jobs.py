"""Job specifications and the Pending/Running/Completed/Failed state machine.

The paper's status protocol (§IV.A) defines exactly four client-visible
states; we keep them verbatim.  A job's *result name* is derived from the
canonical job name's digest, so identical requests share one result object
in the data lake — the unique-name mapping the paper proposes for result
caching (§VII).

The port's copy of ``repro/core/jobs.py``: the same logic, its imports
pointing inside ``repro_torch``.
"""

from __future__ import annotations

import hashlib
import itertools
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, Optional

from .names import DATA_PREFIX, Name, canonical_job_name

__all__ = ["JobState", "JobSpec", "Job", "result_name_for",
           "INPUTS_FIELD", "PRIORITY_FIELD", "SPILL_FIELD",
           "AVOID_FIELD", "TRANSPORT_FIELDS",
           "SESSION_FIELD", "PROMPT_FIELD",
           "encode_input_names", "decode_input_names",
           "encode_spill_path", "decode_spill_path",
           "compress_ranges", "expand_ranges"]

# Job field carrying the data-lake names a computation reads (workflow
# stages use this; the field is part of the canonical name, so the same
# program over different inputs yields different result names).
INPUTS_FIELD = "in"

# Priority class of the job (higher = more urgent; absent = 0).  Part of
# the canonical name — the same work at a different priority is a
# different *request*, but the compute-plane scheduler is what interprets
# it (see repro_torch.core.compute_plane).
PRIORITY_FIELD = "prio"

# Serving-plane session fields.  A session Interest carries its id and a
# *named* prompt — the digest under which the client published the prompt
# tokens to the lake (plus ptoks=, the prompt length, so gateways can
# estimate prefill cost without fetching the prompt).  Both are part of
# the canonical name: distinct sessions are distinct requests, while a
# retransmitted session Interest dedupes onto the running session.
SESSION_FIELD = "sid"
PROMPT_FIELD = "p"

# Hop-carried spill path: when a saturated gateway sheds a compute
# Interest upstream it appends its own cluster name to this field
# (":"-joined).  The field is *transport metadata*: it bounds and
# loop-suppresses decentralized work shedding, and it is excluded from
# the job's signature so a spilled request keeps the canonical result
# name (and result-cache identity) of the original.
SPILL_FIELD = "spill"

# Speculation steering: a speculative re-execution of a straggling task
# carries the cluster(s) believed to be slow (":"-joined, same codec as
# spill=).  A gateway whose cluster appears in the list answers Busy so
# the strategy routes the duplicate elsewhere.  Like spill=, this is
# transport metadata — excluded from the signature so the duplicate keeps
# the original's canonical result name, and the result cache makes the
# race winner exactly-once.
AVOID_FIELD = "avoid"

# Fields that steer *where* a request runs, not *what* it computes — all
# excluded from JobSpec.signature().
TRANSPORT_FIELDS = frozenset({SPILL_FIELD, AVOID_FIELD})


def compress_ranges(parts):
    """Compress sorted-able part indices into [lo, hi) pairs.

    ``[0, 1, 2, 5, 7, 8] -> [[0, 3], [5, 6], [7, 9]]`` — the compact
    form batch receipts and batch status answers carry so a 10k-member
    done-set serializes in O(ranges), not O(members)."""
    out = []
    for p in sorted(set(int(p) for p in parts)):
        if out and p == out[-1][1]:
            out[-1][1] = p + 1
        else:
            out.append([p, p + 1])
    return out


def expand_ranges(ranges):
    """Invert :func:`compress_ranges` back into a sorted index list."""
    out = []
    for lo, hi in ranges:
        out.extend(range(int(lo), int(hi)))
    return out


def encode_spill_path(path) -> str:
    """Join cluster names into the hop-carried ``spill=`` field value."""
    return ":".join(str(p) for p in path)


def decode_spill_path(value: str):
    """Invert :func:`encode_spill_path` (empty value -> empty path)."""
    return [p for p in str(value or "").split(":") if p]


def encode_input_names(names) -> str:
    """Encode data-lake names into one job-field value.

    ``/`` is illegal inside a name component, so each input name is
    flattened with ``:`` and the list joined with ``,`` (both legal
    component characters): ``/lidc/data/a + /lidc/data/b`` ->
    ``lidc:data:a,lidc:data:b``.
    """
    parts = []
    for n in names:
        comps = n.components if isinstance(n, Name) else Name.parse(str(n)).components
        for c in comps:
            # ':' and ',' are the codec's own separators; '&' would break
            # the k=v&k=v job-component parse the value is embedded in
            if ":" in c or "," in c or "&" in c:
                raise ValueError(
                    f"input name component {c!r} cannot contain ':', ',' or '&'")
        parts.append(":".join(comps))
    return ",".join(parts)


def decode_input_names(value: str):
    """Invert :func:`encode_input_names` back into a list of Names."""
    if not value:
        return []
    return [Name(tuple(p for p in item.split(":") if p))
            for item in str(value).split(",")]


class JobState(str, Enum):
    PENDING = "Pending"
    RUNNING = "Running"
    COMPLETED = "Completed"
    FAILED = "Failed"


@dataclass(frozen=True)
class JobSpec:
    """Parsed, validated job description (from the Interest name)."""

    app: str
    fields: Dict[str, Any] = field(default_factory=dict)

    @property
    def arch(self) -> Optional[str]:
        return self.fields.get("arch")

    @property
    def shape(self) -> Optional[str]:
        return self.fields.get("shape")

    def chips(self, default: int = 1) -> int:
        return int(self.fields.get("chips", default))

    def steps(self, default: int = 1) -> int:
        return int(self.fields.get("steps", default))

    def input_names(self):
        """Data-lake names this job reads (workflow stages set these)."""
        return decode_input_names(self.fields.get(INPUTS_FIELD, ""))

    @property
    def priority(self) -> int:
        """Priority class (higher = more urgent; absent/unparseable = 0)."""
        try:
            return int(self.fields.get(PRIORITY_FIELD, 0))
        except (TypeError, ValueError):
            return 0

    def name(self) -> Name:
        return canonical_job_name({"app": self.app, **self.fields})

    def signature(self) -> str:
        """Stable identity of the *work* (drives caching & the scheduler).

        Transport fields (the hop-carried spill path, the speculation
        avoid list) steer *where* the work lands, not what it computes:
        a request shed across clusters — or speculatively re-executed
        away from a straggler — keeps the original's signature, so
        result caching and dedupe see one computation."""
        fields = {k: v for k, v in self.fields.items()
                  if k not in TRANSPORT_FIELDS}
        name = canonical_job_name({"app": self.app, **fields})
        return hashlib.sha256(str(name).encode()).hexdigest()[:16]


def result_name_for(spec: JobSpec) -> Name:
    """Deterministic result location: /lidc/data/results/<job-signature>."""
    return Name.parse(DATA_PREFIX).append("results", spec.signature())


_job_seq = itertools.count(1)


@dataclass
class Job:
    spec: JobSpec
    # empty for a job built outside a cluster (an executor called on its
    # own, as runtime/executors.py's tests and chip_smoke.py call them)
    cluster: str = ""
    job_id: str = ""
    state: JobState = JobState.PENDING
    submitted_at: float = 0.0
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    error: Optional[str] = None
    result: Optional[Dict[str, Any]] = None
    # resources actually granted by the matchmaker
    granted_chips: int = 0
    endpoint: Optional[str] = None
    # times this job was preempted at a phase boundary (compute plane)
    preemptions: int = 0

    def __post_init__(self) -> None:
        if not self.job_id:
            self.job_id = f"{self.cluster}-job-{next(_job_seq)}"

    # -- state machine -------------------------------------------------------
    def start(self, now: float) -> None:
        assert self.state == JobState.PENDING, self.state
        self.state = JobState.RUNNING
        self.started_at = now

    def preempt(self, now: float) -> None:
        """A higher-priority job took the chips at a phase boundary: back
        to Pending; a later :meth:`start` resumes from the checkpoint."""
        assert self.state == JobState.RUNNING, self.state
        self.state = JobState.PENDING
        self.preemptions += 1

    def complete(self, now: float, result: Dict[str, Any]) -> None:
        assert self.state == JobState.RUNNING, self.state
        self.state = JobState.COMPLETED
        self.finished_at = now
        self.result = result

    def fail(self, now: float, error: str) -> None:
        self.state = JobState.FAILED
        self.finished_at = now
        self.error = error

    @property
    def duration(self) -> Optional[float]:
        if self.started_at is None or self.finished_at is None:
            return None
        return self.finished_at - self.started_at

    def status_payload(self) -> Dict[str, Any]:
        """The body of a /lidc/status/<job_id> answer (paper §IV.A)."""
        out: Dict[str, Any] = {"job_id": self.job_id, "state": self.state.value,
                               "cluster": self.cluster}
        if self.state == JobState.COMPLETED:
            out["result_name"] = str(result_name_for(self.spec))
            if self.result:
                out["summary"] = {k: v for k, v in self.result.items()
                                  if isinstance(v, (int, float, str, bool))}
        elif self.state == JobState.FAILED:
            out["error"] = self.error or "unknown"
        return out
