"""The program's spans joined with a traced sub-window's kernels: device
time and idle put down to the span the host was in.

The program records spans on the host's ``time.perf_counter`` (its
``spans`` module), with two clock pairs ``[perf_counter s, Unix ns]``
taken as recording starts and stops; ``torch.profiler`` stamps its events
in Unix nanoseconds.  The pairs place every span on the profiler's axis
(a line through both: their drift is printed).  Then:

- each kernel goes to the innermost span, of any thread, that holds its
  launch (the start of the CUDA runtime call linked to it by correlation
  id), since autograd launches the backward from threads of its own; a
  kernel launched outside every span goes to ``OUTSIDE``;
- each stretch of the sub-window with no kernel running goes to the
  innermost span open on the host during it, split where the host moved
  from one span to another.

A kernel is counted for the part of its interval no earlier kernel
covers, so the device seconds of all spans and ``OUTSIDE`` sum to the busy
seconds, and their idle seconds to the sub-window less its busy seconds.
This module imports nothing of the program.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["OUTSIDE", "clock_map", "drift_us", "Timeline", "attribute", "launched_inside"]

OUTSIDE = "outside"


def clock_map(clocks: Sequence[Sequence[float]]):
    """``perf_counter`` seconds -> profiler ns, the line through the two
    clock pairs."""
    (p0, u0), (p1, u1) = clocks[0], clocks[-1]
    rate = (u1 - u0) / (p1 - p0) if p1 > p0 else 1e9
    return lambda t: u0 + (t - p0) * rate


def drift_us(clocks: Sequence[Sequence[float]]) -> float:
    """How far the two clocks moved apart between the pairs, in us."""
    (p0, u0), (p1, u1) = clocks[0], clocks[-1]
    return ((u1 - u0) - (p1 - p0) * 1e9) / 1e3


class Timeline:
    """The host's time cut into pieces, each owned by the innermost span
    open through it: the latest opened (on one thread, where spans nest,
    the deepest), and of two opened at once the deeper."""

    def __init__(self, spans: List[Dict], clocks: Sequence[Sequence[float]]):
        to_ns = clock_map(clocks)
        self.spans = spans
        depth: List[int] = []
        for s in spans:                       # a parent comes before its children
            depth.append(depth[s["parent"]] + 1 if s["parent"] >= 0 else 0)
        events = []
        for i, s in enumerate(spans):
            if s["end"] is not None:
                a, b = to_ns(s["start"]), to_ns(s["end"])
                if b > a:
                    events += [(a, 1, i), (b, 0, i)]
        events.sort()
        self.starts: List[float] = []
        self.ends: List[float] = []
        self.owner: List[int] = []
        active: Dict[int, Tuple[int, float, int]] = {}
        for k, (t, opening, i) in enumerate(events):
            if opening:
                active[i] = (spans[i]["start"], depth[i], i)
            else:
                active.pop(i)
            nxt = events[k + 1][0] if k + 1 < len(events) else t
            if active and nxt > t:
                self.starts.append(t)
                self.ends.append(nxt)
                self.owner.append(max(active.values())[2])

    def at(self, t: float) -> int:
        """The span that owns host time ``t`` (profiler ns), or -1."""
        k = bisect.bisect_right(self.starts, t) - 1
        return self.owner[k] if k >= 0 and t < self.ends[k] else -1

    def split(self, a: float, b: float) -> Iterable[Tuple[int, float]]:
        """``[a, b)`` cut by owner: (span or -1, ns) pieces."""
        k = max(0, bisect.bisect_right(self.starts, a) - 1)
        t = a
        while t < b and k < len(self.starts):
            s, e = self.starts[k], self.ends[k]
            if e <= t:
                k += 1
                continue
            if s > t:
                yield -1, min(s, b) - t
                t = min(s, b)
                continue
            yield self.owner[k], min(e, b) - t
            t = min(e, b)
            k += 1
        if t < b:
            yield -1, b - t

    def within(self, i: int, name: str) -> bool:
        """Span ``i`` or one that holds it is named ``name``."""
        while i >= 0:
            if self.spans[i]["name"] == name:
                return True
            i = self.spans[i]["parent"]
        return False


def _by_name(tl: Timeline, per_span: Dict[int, float], inclusive: bool) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for i, v in per_span.items():
        if i < 0:
            out[OUTSIDE] = out.get(OUTSIDE, 0.0) + v
            continue
        names = {tl.spans[i]["name"]}
        j = tl.spans[i]["parent"]
        while inclusive and j >= 0:
            names.add(tl.spans[j]["name"])
            j = tl.spans[j]["parent"]
        for n in names:
            out[n] = out.get(n, 0.0) + v
    return out


def attribute(spans: List[Dict], clocks, kernels: Sequence[Tuple[int, int, Optional[int]]],
              window: Tuple[float, float]) -> Dict:
    """Kernels ``(start ns, end ns, launch ns or None)`` of a sub-window
    ``(open, close)`` (``perf_counter`` s) put down to ``spans``: device and
    idle seconds by span name (``self``: the innermost span's alone;
    ``inclusive``: with the spans it lies in), ``OUTSIDE`` for none; for
    each name, the spans opened in the sub-window and the sums of their
    attributes; and the counts and sums that check the join."""
    tl = Timeline(spans, clocks)
    to_ns = clock_map(clocks)
    w0, w1 = to_ns(window[0]), to_ns(window[1])
    device: Dict[int, float] = {}
    idle: Dict[int, float] = {}
    covered = None                      # end of the union of the kernels so far
    busy_in = 0.0                       # busy ns inside the sub-window
    outside = unlinked = 0
    kernels = sorted(kernels)
    for a, b, launch in kernels:
        if covered is not None and a > covered:
            for i, ns in tl.split(max(covered, w0), min(a, w1)):
                idle[i] = idle.get(i, 0.0) + ns
        new = b - max(a, covered) if covered is not None else b - a
        covered = b if covered is None else max(covered, b)
        who = tl.at(launch) if launch is not None else -1
        unlinked += launch is None
        outside += who < 0
        if new > 0:
            device[who] = device.get(who, 0.0) + new
            busy_in += max(0.0, min(b, w1) - max(a, w0, b - new))
    ends = ((w0, w1),) if covered is None else (
        (w0, min(kernels[0][0], w1)), (max(covered, w0), w1))
    for lo, hi in ends:                 # before the first kernel and after the last
        for i, ns in tl.split(lo, hi):
            idle[i] = idle.get(i, 0.0) + ns
    opened: Dict[str, Dict[str, int]] = {}
    for s in spans:
        if s["end"] is not None and w0 <= to_ns(s["start"]) < w1:
            o = opened.setdefault(s["name"], {"spans": 0})
            o["spans"] += 1
            for k, v in s["attrs"].items():
                o[k] = o.get(k, 0) + v
    sec = lambda d: {k: v / 1e9 for k, v in d.items()}  # noqa: E731
    busy = sum(device.values())
    return {"device_self": sec(_by_name(tl, device, False)),
            "device_inclusive": sec(_by_name(tl, device, True)),
            "idle_self": sec(_by_name(tl, idle, False)),
            "idle_inclusive": sec(_by_name(tl, idle, True)),
            "opened": opened, "busy_s": busy / 1e9, "busy_in_window_s": busy_in / 1e9,
            "idle_s": sum(idle.values()) / 1e9, "window_s": (w1 - w0) / 1e9,
            "kernels": len(kernels), "kernels_outside": outside, "kernels_unlinked": unlinked,
            "attributed_share": 1.0 - device.get(-1, 0.0) / busy if busy else None,
            "drift_us": drift_us(clocks)}


def launched_inside(spans: List[Dict], clocks, launches: Iterable[int], name: str
                    ) -> Tuple[int, int]:
    """Of kernels launched at ``launches`` (profiler ns), how many were
    launched inside a span named ``name``, and how many there were."""
    tl = Timeline(spans, clocks)
    n = k = 0
    for t in launches:
        n += 1
        k += tl.within(tl.at(t), name)
    return k, n
