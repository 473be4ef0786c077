"""Unified resilience policy: retry schedules, budgets, circuit breakers.

Before this module, retry/timeout/backoff logic was re-implemented five
times across the stack (consumer no-route fast-retry, workflow engine
noroute/busy/express retries, segment-fetcher RTO backoff, serve
SessionClient re-express, gateway spill fallback), each with its own
magic constants.  Under a correlated failure those layers multiply: N
clients x M layers of independent retries is a storm amplifier with no
shared accounting.

:class:`RetryPolicy` puts every schedule in one place — named defaults
below reproduce the exact legacy constants, and the trace-equivalence
tests (tests/test_resilience.py) prove the migration is behavior-
identical when faults are off.  :class:`RetryBudget` bounds aggregate
retry amplification per name-prefix, and :class:`CircuitBreaker` turns
persistent per-upstream failure into quarantine with probing re-entry
(wired into :class:`~repro_torch.core.strategy.AdaptiveStrategy`).

Everything here is deterministic on the virtual clock: jitter is derived
from a hash of (policy key, attempt), never from wall-clock entropy, so
seeded scenarios replay bit-identically.

The port's copy of ``repro/core/resilience.py``: the same logic, its imports
pointing inside ``repro_torch``.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, replace
from typing import Dict, Hashable, Tuple

__all__ = [
    "RetryPolicy", "RetryBudget", "CircuitBreaker",
    "NOROUTE_FAST_RETRY", "CONSUMER_EXPRESS",
    "ENGINE_EXPRESS", "ENGINE_NOROUTE", "ENGINE_BUSY", "ENGINE_STAGE",
    "FETCH_BACKOFF", "SESSION_EXPRESS", "SESSION_RESUBMIT", "SPILL_RETRY",
]


@dataclass(frozen=True)
class RetryPolicy:
    """A named, deterministic retry schedule.

    ``max_retries`` bounds *retries* (attempts beyond the first);
    :meth:`delay` maps retry number ``n`` (1-based) to a backoff:
    exponential ``base_delay * factor**(n-1)`` by default, or
    ``base_delay * n`` when ``linear`` — capped at ``max_delay`` and
    stretched by a deterministic jitter fraction when ``jitter > 0``.
    """

    max_retries: int
    base_delay: float = 0.0
    factor: float = 2.0
    max_delay: float = float("inf")
    jitter: float = 0.0            # fraction of the delay, added on top
    linear: bool = False

    @property
    def max_attempts(self) -> int:
        """Total tries including the first (retries + 1)."""
        return self.max_retries + 1

    def allows(self, retry: int) -> bool:
        """May retry number ``retry`` (1-based) be made?"""
        return retry <= self.max_retries

    def delay(self, retry: int, key: Hashable = ()) -> float:
        """Backoff before retry ``retry`` (1-based), jittered per key."""
        if retry < 1:
            raise ValueError(f"retry numbers are 1-based, got {retry}")
        if self.linear:
            d = self.base_delay * retry
        else:
            d = self.base_delay * (self.factor ** (retry - 1))
        d = min(d, self.max_delay)
        if self.jitter > 0.0 and d > 0.0:
            d += d * self.jitter * _jitter_fraction(key, retry)
        return d

    def scaled(self, unit: float) -> "RetryPolicy":
        """A copy with delays in units of ``unit`` seconds (e.g. a poll
        interval) — how callers keep instance-level knobs while sharing
        the named schedule shape."""
        return replace(self, base_delay=self.base_delay * unit,
                       max_delay=(self.max_delay * unit
                                  if self.max_delay != float("inf")
                                  else self.max_delay))


def _jitter_fraction(key: Hashable, retry: int) -> float:
    """Deterministic uniform-ish fraction in [0, 1) from (key, retry)."""
    h = hashlib.sha256(repr((key, retry)).encode()).digest()
    return int.from_bytes(h[:8], "big") / 2**64


# ---------------------------------------------------------------------------
# Named defaults.  Each reproduces a pre-existing hard-coded schedule
# exactly; the legacy literal is noted so the equivalence is auditable.
# ---------------------------------------------------------------------------

#: forwarder.Consumer no-route fast-retransmit — was ``noroute_retries < 6``
#: with ``backoff = 0.02 * 2**(n-1)``.
NOROUTE_FAST_RETRY = RetryPolicy(max_retries=6, base_delay=0.02, factor=2.0)

#: forwarder.Consumer.express default — was ``retries=3`` (lifetime-timed,
#: so no delay schedule of its own).
CONSUMER_EXPRESS = RetryPolicy(max_retries=3)

#: workflow engine submit re-express — was ``express_retries=3``.
ENGINE_EXPRESS = RetryPolicy(max_retries=3)

#: workflow engine free no-route retries per stage — was ``< 3``.
ENGINE_NOROUTE = RetryPolicy(max_retries=3)

#: workflow engine busy-cluster re-poll — was ``busy_retries < 4`` with
#: ``delay = poll_interval * busy_retries``; scale by the engine's poll
#: interval via ``ENGINE_BUSY.scaled(poll_interval)``.
ENGINE_BUSY = RetryPolicy(max_retries=4, base_delay=1.0, linear=True)

#: workflow engine whole-stage relaunch cap — was ``max_stage_attempts=4``.
ENGINE_STAGE = RetryPolicy(max_retries=3)   # 3 retries = 4 attempts

#: datalake SegmentFetcher RTO backoff — was ``min(backoff * 2, 64.0)``
#: starting from 1.0, over ``max_retries=10``.
FETCH_BACKOFF = RetryPolicy(max_retries=10, base_delay=1.0, factor=2.0,
                            max_delay=64.0)

#: serve SessionClient chunk/receipt express — was ``retries=8``.
SESSION_EXPRESS = RetryPolicy(max_retries=8)

#: serve SessionClient whole-session resubmit — was ``max_resubmits=8``.
SESSION_RESUBMIT = RetryPolicy(max_retries=8)

#: gateway spill upstream attempt — was ``retries=1`` with local fallback.
SPILL_RETRY = RetryPolicy(max_retries=1)


# ---------------------------------------------------------------------------
# Retry budgets
# ---------------------------------------------------------------------------

class RetryBudget:
    """Token-bucket retry budget, keyed (typically by name-prefix root).

    Each key accrues ``rate`` tokens/sec of virtual time up to ``burst``;
    a retry spends one token.  When the bucket is dry the retry is denied
    — the caller should surface the failure instead of amplifying.  All
    state advances on the caller-supplied clock, so budget decisions are
    deterministic in seeded scenarios.
    """

    def __init__(self, rate: float = 10.0, burst: float = 20.0) -> None:
        self.rate = rate
        self.burst = burst
        self._tokens: Dict[Hashable, Tuple[float, float]] = {}  # key -> (tokens, at)
        self.denied = 0
        self.spent = 0

    def try_spend(self, key: Hashable, now: float, cost: float = 1.0) -> bool:
        tokens, at = self._tokens.get(key, (self.burst, now))
        tokens = min(self.burst, tokens + (now - at) * self.rate)
        if tokens >= cost:
            self._tokens[key] = (tokens - cost, now)
            self.spent += 1
            return True
        self._tokens[key] = (tokens, now)
        self.denied += 1
        return False


# ---------------------------------------------------------------------------
# Circuit breaker
# ---------------------------------------------------------------------------

_CLOSED, _OPEN, _HALF_OPEN = "closed", "open", "half-open"


class CircuitBreaker:
    """Per-key (usually per-upstream-face) failure circuit.

    ``fail_threshold`` consecutive failures open the circuit; while open,
    :meth:`allow` denies the key until ``cooloff`` virtual seconds have
    passed, then admits exactly one half-open probe.  A successful probe
    closes the circuit; a failed one reopens it (fresh cooloff).  This is
    the quarantine/probe-back-in loop the AdaptiveStrategy uses to stop
    routing through a persistently-failing upstream without ever
    forgetting it exists.
    """

    def __init__(self, fail_threshold: int = 5, cooloff: float = 1.0) -> None:
        self.fail_threshold = fail_threshold
        self.cooloff = cooloff
        # key -> [state, consecutive_failures, last_transition_or_probe_at]
        self._state: Dict[Hashable, list] = {}
        self.opened = 0     # transitions to open (telemetry)

    def state(self, key: Hashable) -> str:
        st = self._state.get(key)
        return st[0] if st else _CLOSED

    def allow(self, key: Hashable, now: float) -> bool:
        st = self._state.get(key)
        if st is None or st[0] == _CLOSED:
            return True
        if now - st[2] >= self.cooloff:
            # open past cooloff: admit one half-open probe.  Already
            # half-open past cooloff: the previous probe went unanswered
            # (or was admitted but never routed) — admit another rather
            # than quarantining a healed upstream forever.
            st[0] = _HALF_OPEN
            st[2] = now
            return True
        return False

    def record(self, key: Hashable, ok: bool, now: float) -> None:
        st = self._state.get(key)
        if ok:
            if st is not None:
                self._state.pop(key, None)   # close + forget history
            return
        if st is None:
            st = self._state[key] = [_CLOSED, 0, 0.0]
        if st[0] == _HALF_OPEN:
            # failed probe: reopen with a fresh cooloff window
            st[0] = _OPEN
            st[2] = now
            self.opened += 1
            return
        st[1] += 1
        if st[0] == _CLOSED and st[1] >= self.fail_threshold:
            st[0] = _OPEN
            st[2] = now
            self.opened += 1

    def open_keys(self) -> Tuple[Hashable, ...]:
        return tuple(k for k, st in self._state.items() if st[0] != _CLOSED)


def policy_repr(policy: RetryPolicy) -> str:
    """Short human label used in stats/telemetry dumps."""
    shape = "linear" if policy.linear else f"x{policy.factor:g}"
    return (f"retries={policy.max_retries} base={policy.base_delay:g}s "
            f"{shape} cap={policy.max_delay:g}")


def _self_check() -> None:   # pragma: no cover - sanity hook for REPL use
    assert [NOROUTE_FAST_RETRY.delay(n) for n in range(1, 7)] == \
        [0.02 * 2 ** (n - 1) for n in range(1, 7)]


if __name__ == "__main__":   # pragma: no cover
    _self_check()
    print("resilience defaults:",
          {k: policy_repr(v) for k, v in globals().items()
           if isinstance(v, RetryPolicy)})
