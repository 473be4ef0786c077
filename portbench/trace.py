"""Tracing a sub-window of a run with ``torch.profiler`` and reading it.

A run traces twice after its measured window.  The first trace records
the device alone, so that the host runs at its own pace: the device's busy
seconds (the union of its kernels' intervals) against the sub-window's
length on the host clock give the idle share.  The second also records
the host's ops, and attributes each kernel's device time to the registered
op under which it was launched: the kernel's linked correlation id names
the innermost host op active at its launch, and where that op lies inside
one of ``OPS`` (an op's autograd wrapper, or an aten op it calls), the
kernel is that op's; kernel names are never used.  Events are read off the
profiler's raw results (``kineto_results``), never through
``prof.events()``, which takes tens of seconds for a window of this size.
"""

from __future__ import annotations

import bisect
import time
from contextlib import contextmanager
from typing import Dict, Iterable, List, Tuple

__all__ = ["OPS", "traced", "read"]

# the port's registered ops whose kernels per-layer metrics read
OPS = ("repro_torch::flash_decode", "repro_torch::flash_attention_infer",
       "repro_torch::flash_attention", "repro_torch::flash_attention_bwd")
TOP = 10


@contextmanager
def traced(store: Dict, key: str, host_ops: bool):
    """Profile the body (the device, and with ``host_ops`` the host's ops);
    on exit the reading of the trace is in ``store[key]``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] * host_ops + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    store[key] = read(prof, window)


def _union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def read(prof, window_s: float) -> Dict:
    """The device's busy seconds in a traced sub-window of ``window_s``
    host seconds, the device seconds of each op of ``OPS`` and of each
    host op, the ten kernels that took most time, and the ten host ops
    after whose launches the device had waited longest."""
    from torch.autograd import DeviceType
    res = prof.profiler.kineto_results
    ops: Dict[int, Tuple[str, int]] = {}      # correlation id -> (name, start)
    launches: Dict[int, int] = {}             # runtime call's correlation id -> start
    spans: Dict[str, List[Tuple[int, int]]] = {op: [] for op in OPS}
    kernels = []
    for e in res.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                kernels.append((e.start_ns(), e.end_ns(), name, e.linked_correlation_id(),
                                e.correlation_id()))
        elif name.startswith("cu"):           # a CUDA runtime or driver call
            launches[e.correlation_id()] = e.start_ns()
        else:
            ops[e.correlation_id()] = (name, e.start_ns())
            if name in spans:
                spans[name].append((e.start_ns(), e.end_ns()))
    for ivs in spans.values():
        ivs.sort()

    def enclosing(t: int):
        """The innermost of ``OPS`` whose host interval holds time ``t``."""
        best = None
        for op, ivs in spans.items():
            i = bisect.bisect_right(ivs, (t, float("inf"))) - 1
            if i >= 0 and ivs[i][0] <= t <= ivs[i][1] and (best is None or ivs[i][0] > best[1]):
                best = (op, ivs[i][0])
        return best[0] if best else None

    def launcher(linked: int, corr: int) -> str:
        if linked in ops:
            name, start = ops[linked]
            return name if name in spans else (enclosing(start) or name)
        t = launches.get(corr)
        return (enclosing(t) if t is not None else None) or "unattributed"

    by_op: Dict[str, int] = {}
    by_kernel: Dict[str, int] = {}
    order = []
    for a, b, name, link, corr in sorted(kernels):
        who = launcher(link, corr) if ops else "not traced"
        order.append((a, b, who))
        by_op[who] = by_op.get(who, 0) + b - a
        by_kernel[name[:160]] = by_kernel.get(name[:160], 0) + b - a
    busy = _union((a, b) for a, b, _ in order)
    gaps: Dict[str, int] = {}
    starts = [a for a, _, _ in order]
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        label = order[bisect.bisect_left(starts, nxt)][2]
        gaps[label] = gaps.get(label, 0) + nxt - end

    def top(d: Dict[str, int]) -> List[List]:
        return [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    busy_s = sum(b - a for a, b in busy) / 1e9
    return {"window_s": window_s, "busy_s": busy_s,
            "op_device_s": {op: by_op.get(op, 0) / 1e9 for op in OPS},
            "kernels": len(order), "attributed": sum(w not in ("unattributed", "not traced")
                                                     for _, _, w in order),
            "device_ops": top(by_kernel), "by_op": top(by_op), "idle_gaps": top(gaps)}
