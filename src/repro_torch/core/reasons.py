"""The Nack-reason and failure-reason vocabulary, in one place.

Every negative signal in the system — forwarder no-route, gateway
rejections, data-lake misses, consumer-side failure strings — used to be
an ad-hoc string literal scattered across modules, and strategies/tests
string-matched them by hand.  This module is the single typed vocabulary:

* **Transport / capacity** reasons (``no-route``, ``no-capacity``,
  ``busy``, ``cluster-down``, timeouts) count as *path loss* for the
  forwarding strategies: the upstream could not do the work, divert.
* **Authoritative answers** (``data-not-found``) mean "I am healthy and
  the answer is no" — scoring them as loss would poison the loss EWMA of
  perfectly healthy replicas (see ``Forwarder._on_nack``).
* **Protocol rejections** (``malformed-job-name``, ``unknown-job``,
  ``status-needs-job-id``, ``validation:*``) are client errors; they are
  never retried by the network.

Reasons that carry detail use a ``<kind>:<detail>`` shape; :func:`kind_of`
recovers the stable kind for counters and tests.  Consumer-side failure
strings wrap a Nack reason as ``nack:<reason>`` (:func:`nack_failure`) or
are the bare ``timeout``.

The port's copy of ``repro/core/reasons.py``: the same logic, its imports
pointing inside ``repro_torch``.
"""

from __future__ import annotations

__all__ = [
    "NO_ROUTE", "NO_CAPACITY", "BUSY", "CLUSTER_DOWN", "DATA_NOT_FOUND",
    "MALFORMED_JOB_NAME", "UNKNOWN_JOB", "STATUS_NEEDS_JOB_ID",
    "VALIDATION", "TIMEOUT", "NACK_PREFIX",
    "validation_reason", "no_capacity_reason", "kind_of", "nack_failure",
    "failure_kind", "is_authoritative", "is_busy_failure",
    "is_no_route_failure",
]

# -- forwarder-level ---------------------------------------------------------
NO_ROUTE = "no-route"                  # no usable FIB nexthop
# -- gateway-level -----------------------------------------------------------
NO_CAPACITY = "no-capacity"            # structurally infeasible here
BUSY = "busy"                          # feasible but saturated (carries eta)
CLUSTER_DOWN = "cluster-down"          # gateway alive, cluster runtime dark
MALFORMED_JOB_NAME = "malformed-job-name"
UNKNOWN_JOB = "unknown-job"
STATUS_NEEDS_JOB_ID = "status-needs-job-id"
VALIDATION = "validation"              # kind prefix: "validation:<detail>"
# -- data-lake ---------------------------------------------------------------
DATA_NOT_FOUND = "data-not-found"      # authoritative negative answer
# -- consumer-side failure strings ------------------------------------------
TIMEOUT = "timeout"
NACK_PREFIX = "nack:"


def validation_reason(detail: object) -> str:
    """``validation:<detail>`` — a per-app validator rejected the job."""
    return f"{VALIDATION}:{detail}"


def no_capacity_reason(detail: object) -> str:
    """``no-capacity:<detail>`` — matchmaking failed structurally."""
    return f"{NO_CAPACITY}:{detail}"


def kind_of(reason: str) -> str:
    """Stable kind of a possibly-detailed reason (``validation:x`` ->
    ``validation``); used by rejection counters and tests."""
    return reason.split(":", 1)[0]


def nack_failure(reason: str) -> str:
    """The consumer-side failure string for a propagated Nack."""
    return f"{NACK_PREFIX}{reason}"


def is_authoritative(reason: str) -> bool:
    """Authoritative negative answers must not count as path loss."""
    return kind_of(reason) == DATA_NOT_FOUND


def failure_kind(failure: str) -> str:
    """The stable kind of a consumer-side failure string.

    Strips the *first* ``nack:`` wrapper only, then takes the reason
    kind: a detailed reason may embed further reasons
    (``nack:busy:spill-failed:nack:no-route`` is a *busy* receipt whose
    detail happens to mention the spill path's no-route — matching on
    the tail would misclassify it)."""
    if failure.startswith(NACK_PREFIX):
        failure = failure[len(NACK_PREFIX):]
    return kind_of(failure)


def is_busy_failure(failure: str) -> bool:
    """Did a consumer-side failure string carry a busy receipt?"""
    return failure_kind(failure) == BUSY


def is_no_route_failure(failure: str) -> bool:
    return failure_kind(failure) == NO_ROUTE
