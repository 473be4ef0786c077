"""Windowed segment fetcher — the consumer half of the bulk-data fast path.

``ndn-tools catchunks`` style: discover the object's manifest, then pull
the ``seg=i`` Data packets under an AIMD congestion window —

* **slow start / congestion avoidance** — the window grows by one segment
  per ack below ``ssthresh``, by ``1/cwnd`` above it;
* **multiplicative decrease** — a timeout or Nack halves the window (at
  most once per RTT, so one loss burst is one congestion event) and backs
  the RTO off exponentially until a fresh RTT sample arrives;
* **delay-based growth gate** — the window stops growing while the
  latest RTT sample exceeds ``delay_factor`` × the minimum observed RTT
  (Vegas-style): on a loss-free path the only congestion signal is the
  queue the fetcher itself builds, and without the gate the window grows
  until queueing delay trips the RTO — spurious retransmissions of data
  that was merely parked on a busy link;
* **adaptive RTO** — RFC 6298 SRTT/RTTVAR from per-segment RTT samples
  (Karn's rule: retransmitted segments don't feed the estimator), seeded
  from the attached forwarder's per-face ``NextHop.rtt_ewma`` telemetry
  when the prefix has been measured before;
* **incremental reassembly** — segments land at their byte offset in a
  preallocated buffer, so arrival order never matters and no quadratic
  join happens at the end.

Because segments are ordinary named Data, everything upstream composes
for free: intermediate Content Stores cache at segment granularity
(partial hits, many consumers sharing one upstream stream), PIT entries
aggregate concurrent fetchers, and a window-splitting strategy
(:class:`~repro_torch.core.strategy.AdaptiveStrategy` with ``split_segments``)
spreads the in-flight window across every cluster announcing the data
prefix — multi-replica parallel fetch with no replica protocol at all.

Unsegmented objects short-circuit: manifest discovery Nacks with
``data-not-found`` and the fetcher falls back to a single bare-name
fetch.  Either way the delivered bytes are byte-identical to the
:meth:`~repro_torch.datalake.lake.DataLake.get_bytes` oracle.

The port's copy of ``repro/datalake/fetch.py``: the same logic, its imports
pointing inside ``repro_torch``.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core import reasons
from ..core.forwarder import Consumer, Forwarder, Network
from ..core.names import Name
from ..core.packets import Data, Interest, verify_data
from ..core.resilience import FETCH_BACKOFF, RetryPolicy

__all__ = ["SegmentFetcher", "fetch"]


class SegmentFetcher:
    """Fetch one named object through the windowed segment pipeline."""

    def __init__(self, net: Network, node: Forwarder, name: Name, *,
                 consumer: Optional[Consumer] = None,
                 on_complete: Optional[Callable[[bytes], None]] = None,
                 on_error: Optional[Callable[[str], None]] = None,
                 init_cwnd: float = 2.0, init_ssthresh: float = 64.0,
                 md_factor: float = 0.5,
                 max_retries: int = FETCH_BACKOFF.max_retries,
                 backoff_policy: RetryPolicy = FETCH_BACKOFF,
                 min_rto: float = 0.05, max_rto: float = 2.0,
                 default_rto: float = 0.2, lifetime_factor: float = 4.0,
                 delay_factor: float = 1.8, rto_headroom: float = 1.5,
                 single_retries: int = 2,
                 single_lifetime: Optional[float] = None,
                 verify_key: Optional[bytes] = None,
                 record_trace: bool = True,
                 on_segment: Optional[Callable[[int, Data], None]] = None,
                 have: Optional[Dict[int, bytes]] = None,
                 admit: Optional[Callable[[Dict[str, Any]], bool]] = None):
        self.net = net
        self.node = node
        self.name = name
        self._owns_consumer = consumer is None
        self.consumer = consumer or Consumer(net, node, name="seg-fetch")
        self.on_complete = on_complete
        self.on_error = on_error
        self.init_cwnd = max(1.0, float(init_cwnd))
        self.cwnd = self.init_cwnd
        self.ssthresh = float(init_ssthresh)
        self.md_factor = md_factor
        self.max_retries = max_retries
        self.min_rto = min_rto
        self.max_rto = max_rto
        self.default_rto = default_rto
        self.lifetime_factor = lifetime_factor
        self.delay_factor = delay_factor
        self.rto_headroom = rto_headroom
        # policy for the unsegmented-object fallback fetch (callers like the
        # workflow engine thread their own retry/lifetime settings through)
        self.single_retries = single_retries
        self.single_lifetime = single_lifetime
        self.verify_key = verify_key
        self.record_trace = record_trace
        # replication-manager hooks: ``on_segment`` observes each verified
        # segment as it lands (incremental persistence for crash-resume),
        # ``have`` pre-seeds already-fetched segments so a resumed
        # transfer pulls only what is missing, ``admit`` sees the parsed
        # manifest before any segment Interest goes out and may refuse
        # the transfer (byte-budget admission control)
        self.on_segment = on_segment
        self._have = dict(have) if have else {}
        self.admit = admit

        # rto estimator (RFC 6298), seeded from forwarder telemetry.  The
        # timeout backoff multiplier follows the named FETCH_BACKOFF
        # schedule (x2 per consecutive timeout, capped — identical to the
        # historical inline doubling) and resets on a fresh RTT sample.
        self.backoff_policy = backoff_policy
        self._srtt: Optional[float] = None
        self._rttvar: float = 0.0
        self._backoff_n = 0
        self._backoff = backoff_policy.delay(1)
        self._single_tries = 0
        self._base_rtt: Optional[float] = None   # min observed (delay gate)
        self._base_rtt_age = 0                   # acks since the min was set
        self._seed_rto_from_telemetry()

        # reassembly state
        self.manifest: Optional[Dict[str, Any]] = None
        self._buf: Optional[bytearray] = None
        self._nseg = 0
        self._seg_size = 0
        self._next_seg = 0
        self._bytes_received = 0
        self._received: set = set()
        self._in_flight: set = set()
        self._retx_queue: List[int] = []
        self._sent_at: Dict[int, float] = {}
        self._retx_count: Dict[int, int] = {}
        self._last_decrease = -1e18
        self._manifest_tries = 0

        # observability
        self.state = "idle"            # idle→manifest→windowed|single→done|failed
        self.result: Optional[bytes] = None
        self.error: Optional[str] = None
        self.trace: List[Tuple[float, float, str]] = []   # (t, cwnd, event)
        self.stats: Dict[str, float] = {
            "segments": 0, "retransmissions": 0, "timeouts": 0, "nacks": 0,
            "window_decreases": 0, "bytes": 0, "duration": 0.0, "goodput": 0.0,
            "max_cwnd": self.cwnd, "resumed": 0,
        }
        self.started_at: Optional[float] = None

    # ------------------------------------------------------------------ rto
    def _seed_rto_from_telemetry(self) -> None:
        _, hops = self.node.fib.lookup(self.name)
        rtts = [h.rtt_ewma for h in hops if h.rtt_ewma > 0]
        if rtts:
            self._srtt = min(rtts)
            self._rttvar = self._srtt / 2

    def _note_rtt(self, sample: float) -> None:
        if self._srtt is None:
            self._srtt = sample
            self._rttvar = sample / 2
        else:
            self._rttvar = 0.75 * self._rttvar + 0.25 * abs(self._srtt - sample)
            self._srtt = 0.875 * self._srtt + 0.125 * sample
        self._backoff_n = 0
        self._backoff = self.backoff_policy.delay(1)

    def _bump_backoff(self) -> None:
        self._backoff_n += 1
        self._backoff = self.backoff_policy.delay(self._backoff_n + 1)

    def _rto(self) -> float:
        # headroom over the textbook srtt+4·rttvar: on a loss-free path the
        # estimator trails the queue the window itself builds, and a too-
        # tight RTO turns that queue into spurious retransmitted megabytes
        base = (self._srtt + 4 * self._rttvar) * self.rto_headroom \
            if self._srtt is not None else self.default_rto
        return min(max(base * self._backoff, self.min_rto), self.max_rto)

    # ---------------------------------------------------------------- window
    def _trace(self, event: str) -> None:
        if self.record_trace:
            self.trace.append((self.net.now, self.cwnd, event))

    def _decrease_window(self, why: str) -> None:
        """Multiplicative decrease, at most once per RTT (one loss burst =
        one congestion event, catchunks-style)."""
        now = self.net.now
        rtt = self._srtt if self._srtt is not None else self.default_rto
        if now - self._last_decrease < rtt:
            return
        self._last_decrease = now
        self.ssthresh = max(self.cwnd * self.md_factor, self.init_cwnd)
        self.cwnd = max(self.cwnd * self.md_factor, 1.0)
        self.stats["window_decreases"] += 1
        self._trace(f"md:{why}")

    def _increase_window(self, rtt_sample: Optional[float]) -> None:
        if rtt_sample is not None:
            self._base_rtt_age += 1
            # LEDBAT-style aging: a stale minimum (one lucky Content-Store
            # hit early on) must not pin the window for the whole transfer
            if (self._base_rtt is None or rtt_sample < self._base_rtt
                    or self._base_rtt_age > 64):
                self._base_rtt = rtt_sample
                self._base_rtt_age = 0
            elif rtt_sample > self._base_rtt * self.delay_factor:
                self._trace("delay-hold")
                return   # our own queue is the delay: stop inflating it
        if self.cwnd < self.ssthresh:
            self.cwnd += 1.0                      # slow start
        else:
            self.cwnd += 1.0 / self.cwnd          # congestion avoidance
        self.stats["max_cwnd"] = max(self.stats["max_cwnd"], self.cwnd)

    # ------------------------------------------------------------------ api
    def start(self) -> "SegmentFetcher":
        assert self.state == "idle", "fetcher instances are single-use"
        self.started_at = self.net.now
        self.state = "manifest"
        self._express_manifest()
        return self

    # ------------------------------------------------------------- manifest
    def _express_manifest(self) -> None:
        if self.state != "manifest":
            return  # a scheduled nack-retry outlived the discovery phase
        self._manifest_tries += 1
        rto = self._rto()
        self.consumer.express(
            Interest(name=self.name.append("manifest"),
                     lifetime=rto * self.lifetime_factor),
            on_data=self._on_manifest,
            on_fail=self._on_manifest_fail,
            retries=0, rto=rto)

    def _on_manifest(self, d: Data) -> None:
        if self.state != "manifest":
            return
        if self.verify_key is not None and not verify_data(d, self.verify_key):
            # a corrupted manifest is a transient wire fault, not a verdict
            # on the object: retry (bounded by the manifest try budget)
            self._on_manifest_fail("bad-signature")
            return
        try:
            self.manifest = json.loads(bytes(d.content).decode())
            self._nseg = int(self.manifest["segments"])
            size = int(self.manifest["size"])
            if "segment_size" in self.manifest:
                self._seg_size = int(self.manifest["segment_size"])
            elif self._nseg == 1:
                self._seg_size = size
            else:
                # guessing (e.g. ceil(size/nseg)) can misplace offsets and
                # silently corrupt the reassembly — refuse instead
                raise ValueError("multi-segment manifest without segment_size")
        except (ValueError, KeyError) as e:
            self._fail(f"manifest-malformed:{e}")
            return
        if self.admit is not None and not self.admit(self.manifest):
            self._fail("admission-refused")
            return
        self._buf = bytearray(size)
        self.state = "windowed"
        self._trace("manifest")
        # resume: segments fetched by a previous (crashed/failed) transfer
        # land straight in the buffer; only the gap goes on the wire
        for i in sorted(self._have):
            chunk = self._have[i]
            if 0 <= i < self._nseg and i not in self._received:
                off = i * self._seg_size
                self._buf[off:off + len(chunk)] = chunk
                self._received.add(i)
                self._bytes_received += len(chunk)
                self.stats["resumed"] += 1
        if self._nseg and len(self._received) == self._nseg:
            if self._bytes_received != len(self._buf):
                self._fail(f"size-mismatch:{self._bytes_received}"
                           f"!={len(self._buf)}")
            else:
                self._finish(bytes(self._buf))
            return
        self._fill_window()

    def _on_manifest_fail(self, reason: str) -> None:
        if self.state != "manifest":
            return
        if reason == reasons.nack_failure(reasons.DATA_NOT_FOUND):
            # authoritative "no such manifest": the object is unsegmented
            # (or absent) — a single bare-name fetch decides.  Transport
            # Nacks (no-route during churn/partition) are transient and
            # retry below instead of downgrading a segmented object to a
            # monolithic fetch for good.
            self.state = "single"
            self._trace("fallback-single")
            self._express_single()
            return
        if self._manifest_tries > self.max_retries:
            self._fail(f"manifest:{reason}")
        elif reason.startswith("nack"):
            # transient transport Nack (no-route mid-churn): wait out the
            # routing churn one RTO before retrying, or a fast Nack loop
            # would burn every retry in milliseconds
            self.stats["nacks"] += 1
            self.net.schedule(self._rto(), self._express_manifest)
        else:
            self.stats["timeouts"] += 1
            self._bump_backoff()
            self._express_manifest()

    def _express_single(self) -> None:
        self._single_tries += 1
        lifetime = (self.single_lifetime if self.single_lifetime
                    is not None else self._rto() * self.lifetime_factor * 2)
        self.consumer.express(
            Interest(name=self.name, lifetime=lifetime),
            on_data=self._on_single,
            on_fail=lambda r: self._fail(f"single:{r}"),
            retries=self.single_retries)

    def _on_single(self, d: Data) -> None:
        if self.state != "single":
            return
        if self.verify_key is not None and not verify_data(d, self.verify_key):
            # corrupted in flight: re-fetch (must_be_fresh-less name may be
            # served verified from an uncorrupted path or the origin)
            if self._single_tries <= self.max_retries:
                self._trace("single-bad-signature")
                self._bump_backoff()
                self.net.schedule(self._rto(), self._express_single)
            else:
                self._fail("single-signature")
            return
        self._finish(bytes(d.content))

    # ------------------------------------------------------------- segments
    def _fill_window(self) -> None:
        while (len(self._in_flight) < int(self.cwnd)
               and (self._retx_queue or self._next_seg < self._nseg)):
            if self._retx_queue:
                i = self._retx_queue.pop(0)
                self.stats["retransmissions"] += 1
            else:
                i = self._next_seg
                self._next_seg += 1
            if i in self._received or i in self._in_flight:
                continue
            self._express_segment(i)

    def _express_segment(self, i: int) -> None:
        rto = self._rto()
        self._in_flight.add(i)
        self._sent_at[i] = self.net.now
        self.consumer.express(
            Interest(name=self.name.append(f"seg={i}"),
                     lifetime=rto * self.lifetime_factor),
            on_data=lambda d, i=i: self._on_segment(i, d),
            on_fail=lambda r, i=i: self._on_segment_fail(i, r),
            retries=0, rto=rto)

    def _on_segment(self, i: int, d: Data) -> None:
        if self.state != "windowed" or i in self._received:
            return
        if self.verify_key is not None and not verify_data(d, self.verify_key):
            self._on_segment_fail(i, "bad-signature")
            return
        self._in_flight.discard(i)
        self._received.add(i)
        self.stats["segments"] += 1
        sample: Optional[float] = None
        if self._retx_count.get(i, 0) == 0 and i in self._sent_at:
            sample = self.net.now - self._sent_at[i]
            self._note_rtt(sample)                # Karn's rule: no retx samples
        off = i * self._seg_size
        self._buf[off:off + len(d.content)] = d.content
        self._bytes_received += len(d.content)
        if self.on_segment is not None:
            self.on_segment(i, d)    # after verification: never a bad byte
        self._increase_window(sample)
        self._trace("ack")
        if len(self._received) == self._nseg:
            # whole-object integrity: segment lengths must tile the manifest
            # size exactly, or the buffer holds silent gaps/overlaps
            if self._bytes_received != len(self._buf):
                self._fail(f"size-mismatch:{self._bytes_received}"
                           f"!={len(self._buf)}")
                return
            self._finish(bytes(self._buf))
            return
        self._fill_window()

    def _on_segment_fail(self, i: int, reason: str) -> None:
        if self.state != "windowed" or i in self._received:
            return
        self._in_flight.discard(i)
        n = self._retx_count.get(i, 0) + 1
        self._retx_count[i] = n
        if reason.startswith("nack"):
            self.stats["nacks"] += 1
        else:
            self.stats["timeouts"] += 1
            self._bump_backoff()
        if n > self.max_retries:
            self._fail(f"seg={i}:{reason}")
            return
        self._decrease_window(reason.split(":")[0])
        self._retx_queue.append(i)
        self._fill_window()

    # ------------------------------------------------------------ terminal
    def _release_consumer(self) -> None:
        """Detach the auto-created consumer face: a long-lived client
        looping ``fetch()`` must not grow the forwarder's face table by
        one entry per object (late packets to the dead face are dropped
        by the node's membership checks)."""
        if self._owns_consumer:
            face = self.consumer.face
            face.down = True
            self.node.faces.pop(face.face_id, None)

    def _finish(self, blob: bytes) -> None:
        self.state = "done"
        self.result = blob
        dur = self.net.now - (self.started_at or 0.0)
        self.stats["bytes"] = len(blob)
        self.stats["duration"] = dur
        self.stats["goodput"] = len(blob) / dur if dur > 0 else float("inf")
        self._trace("done")
        self._release_consumer()
        if self.on_complete:
            self.on_complete(blob)

    def _fail(self, reason: str) -> None:
        self.state = "failed"
        self.error = reason
        self._trace(f"fail:{reason}")
        self._release_consumer()
        if self.on_error:
            self.on_error(reason)


def fetch(net: Network, node: Forwarder, name: Name, **kw) -> SegmentFetcher:
    """Start a fetch and drive the network to quiescence (sync helper)."""
    fetcher = SegmentFetcher(net, node, name, **kw).start()
    net.run()
    return fetcher
