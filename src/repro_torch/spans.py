"""Spans of the port's hot path, kept in memory while recording is on.

A span is a named interval of the host's ``time.perf_counter`` (the clock
the serving engine already reads for its counters), with the span that
holds it, the thread that opened it and a few integer attributes.  The
engine and the training step open spans at their boundaries; a caller that
wants them turns recording on with :func:`start` and takes them back with
:func:`stop`.

Recording is off by default, and then a call site costs one test of the
module's ``on``: no clock read and no allocation.  Every call site reads::

    with (spans.span("name", key=1) if spans.on else spans.OFF):
        ...

or, from two clock reads the caller took anyway::

    if spans.on:
        spans.record("name", t0, t1, key=1)

:func:`start` and :func:`stop` each take a pair of readings, ``perf_counter``
beside ``time.time_ns``: the clock on which ``torch.profiler``'s events
are stamped (Unix nanoseconds).  The two pairs place every span on the
profiler's time axis.  Nothing here waits on the device.
"""

from __future__ import annotations

import threading
import time
from contextlib import nullcontext
from typing import Dict, List, Optional, Tuple

__all__ = ["on", "OFF", "start", "stop", "span", "record", "self_times"]

on = False          # tested at every call site; set only by start() and stop()
OFF = nullcontext()

# each span: {"name", "start", "end", "parent" (its holder's index, or -1),
# "thread", "attrs"}
_spans: List[Dict] = []
_open = threading.local()       # per thread: the stack of open spans' indices
_clocks: List[Tuple[float, int]] = []


def _pair() -> Tuple[float, int]:
    """``perf_counter`` (the mean of a read before and one after) beside
    ``time.time_ns``."""
    a = time.perf_counter()
    unix = time.time_ns()
    return (a + time.perf_counter()) / 2, unix


def _stack() -> List[int]:
    st = getattr(_open, "stack", None)
    if st is None:
        st = _open.stack = []
    return st


def _add(name: str, start: float, end: Optional[float], parent: int, attrs: Dict) -> int:
    _spans.append({"name": name, "start": start, "end": end, "parent": parent,
                   "thread": threading.get_ident(), "attrs": attrs})
    return len(_spans) - 1


def start() -> None:
    """Drop what was recorded and turn recording on."""
    global on
    _spans.clear()
    _clocks[:] = [_pair()]
    _open.stack = []
    on = True


def stop() -> Dict:
    """Turn recording off; the spans, in the order they were recorded (a
    ``with`` span on entry), and the two clock pairs ``[perf_counter s,
    Unix ns]`` taken at :func:`start` and here."""
    global on
    on = False
    out = {"spans": _spans[:], "clocks": [list(c) for c in _clocks + [_pair()]]}
    _spans.clear()
    _clocks.clear()
    return out


class span:
    """A span from now to the end of the ``with`` block, inside the
    innermost span this thread has open."""

    __slots__ = ("index",)

    def __init__(self, name: str, **attrs: int):
        st = _stack()
        self.index = _add(name, time.perf_counter(), None, st[-1] if st else -1, attrs)
        st.append(self.index)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        _spans[self.index]["end"] = time.perf_counter()
        _stack().pop()
        return False


def record(name: str, start: float, end: float, parent: Optional[int] = None,
           **attrs: int) -> int:
    """A span from two ``perf_counter`` readings the caller took; its
    parent is ``parent`` (an index :func:`record` returned) or else the
    innermost span this thread has open.  Returns its index."""
    if parent is None:
        st = _stack()
        parent = st[-1] if st else -1
    return _add(name, start, end, parent, attrs)


def self_times(spans: List[Dict]) -> List[float]:
    """Each span's length less the part of it its children cover (children
    of one span do not overlap: each thread's spans nest)."""
    own = [s["end"] - s["start"] for s in spans]
    for s in spans:
        if s["parent"] >= 0:
            own[s["parent"]] -= s["end"] - s["start"]
    return own
