"""``attribution.py`` on hand-built spans and kernels: a kernel goes to the
innermost span that holds its launch, of any thread; an idle stretch is
split between the spans the host passed through; a launch outside every
span goes to ``outside``; and the sums close on the busy and idle seconds."""

import pytest

from portbench import attribution as at

# perf_counter seconds map to profiler ns one to one (times in ms below)
CLOCKS = [[0.0, 0], [1.0, 1_000_000_000]]
MS = 1e6


def _span(name, start, end, parent=-1, thread=1, **attrs):
    return {"name": name, "start": start / 1e3, "end": end / 1e3, "parent": parent,
            "thread": thread, "attrs": attrs}


# an iteration 0-100 ms holding a decode 10-60 (its sync 50-60) and a prefill
# 70-90; another thread's span 20-30 with nothing nested
SPANS = [_span("engine.iteration", 0, 100),
         _span("engine.decode", 10, 60, parent=0, busy=4),
         _span("engine.sync", 50, 60, parent=1),
         _span("engine.prefill", 70, 90, parent=0, tokens=1000),
         _span("autograd", 20, 30, thread=2)]


def _k(a, b, launch):
    return (a * MS, b * MS, None if launch is None else launch * MS)


def test_innermost_span_takes_the_kernel():
    r = at.attribute(SPANS, CLOCKS, [_k(12, 20, 11), _k(52, 55, 51), _k(75, 80, 22)],
                     (0.0, 0.1))
    assert r["device_self"]["engine.decode"] == pytest.approx(0.008)
    assert r["device_self"]["engine.sync"] == pytest.approx(0.003)
    # launched at 22 ms, inside the decode and the other thread's span: the
    # later opened of the two is the innermost
    assert r["device_self"]["autograd"] == pytest.approx(0.005)
    assert r["device_inclusive"]["engine.decode"] == pytest.approx(0.011)
    assert r["device_inclusive"]["engine.iteration"] == pytest.approx(0.011)
    assert r["kernels_outside"] == 0 and r["attributed_share"] == 1.0


def test_idle_is_split_between_the_spans_the_host_passed():
    # one kernel 0-45 ms, one 95-100: idle 45-95 crosses the decode, its
    # sync, the iteration alone, and the prefill
    r = at.attribute(SPANS, CLOCKS, [_k(0, 45, 5), _k(95, 100, 92)], (0.0, 0.1))
    idle = r["idle_self"]
    assert idle["engine.decode"] == pytest.approx(0.005)
    assert idle["engine.sync"] == pytest.approx(0.010)
    assert idle["engine.prefill"] == pytest.approx(0.020)
    assert idle["engine.iteration"] == pytest.approx(0.015)
    assert r["idle_inclusive"]["engine.decode"] == pytest.approx(0.015)
    assert r["idle_s"] == pytest.approx(0.050) == pytest.approx(r["window_s"] - r["busy_s"])
    assert sum(idle.values()) == pytest.approx(r["idle_s"])
    # both launched in the iteration alone (at 5 ms and at 92 ms)
    assert r["device_self"] == {"engine.iteration": pytest.approx(0.050)}


def test_a_launch_outside_every_span_goes_outside():
    r = at.attribute(SPANS, CLOCKS, [_k(101, 105, 100.5), _k(106, 108, None)], (0.0, 0.11))
    assert r["device_self"] == {at.OUTSIDE: pytest.approx(0.006)}
    assert r["kernels_outside"] == 2 and r["kernels_unlinked"] == 1
    assert r["attributed_share"] == 0.0
    # idle: 0-100 ms in the host's spans, 100-101, 105-106 and 108-110 outside
    assert r["idle_self"][at.OUTSIDE] == pytest.approx(0.004)
    # (20-30 ms to the other thread's span, opened later than the decode)
    assert r["idle_inclusive"]["engine.iteration"] == pytest.approx(0.09)
    assert r["idle_self"]["autograd"] == pytest.approx(0.01)
    assert r["idle_s"] == pytest.approx(0.11 - 0.006)


def test_overlapping_kernels_count_once():
    r = at.attribute(SPANS, CLOCKS, [_k(12, 20, 11), _k(15, 25, 71)], (0.0, 0.1))
    assert r["busy_s"] == pytest.approx(0.013)
    assert r["device_self"]["engine.prefill"] == pytest.approx(0.005)
    assert r["idle_s"] == pytest.approx(0.1 - 0.013)


def test_a_window_with_no_kernel_is_idle_once():
    r = at.attribute(SPANS, CLOCKS, [], (0.0, 0.1))
    assert r["idle_s"] == pytest.approx(0.1) and r["busy_s"] == 0
    assert r["attributed_share"] is None
    assert r["opened"] == {"engine.iteration": {"spans": 1},
                           "engine.decode": {"spans": 1, "busy": 4},
                           "engine.sync": {"spans": 1},
                           "engine.prefill": {"spans": 1, "tokens": 1000},
                           "autograd": {"spans": 1}}
    assert at.attribute(SPANS, CLOCKS, [], (0.015, 0.1))["opened"]["engine.sync"] == {
        "spans": 1}
    assert "engine.decode" not in at.attribute(SPANS, CLOCKS, [], (0.015, 0.1))["opened"]


def test_clock_pairs_map_and_drift():
    clocks = [[10.0, 5_000_000_000], [12.0, 7_000_002_000]]
    to_ns = at.clock_map(clocks)
    assert to_ns(10.0) == 5_000_000_000 and to_ns(12.0) == pytest.approx(7_000_002_000)
    assert at.drift_us(clocks) == pytest.approx(2.0)


def test_launched_inside_counts_by_ancestor():
    launches = [x * MS for x in (11, 55, 75, 95, 120)]
    assert at.launched_inside(SPANS, CLOCKS, launches, "engine.decode") == (2, 5)
    assert at.launched_inside(SPANS, CLOCKS, launches, "engine.iteration") == (4, 5)
