"""Serving driver: the port's ``ServeEngine`` under a closed loop of
clients, one engine iteration (``run(max_steps=1)``: admit, then one
decode step) at a time.

Set-up builds the engine with the seeded model, prefills a grid of
prompt lengths across the mix's range once (the GEMM variants a prefill
can take are loaded; lengths between the grid's reach the window unseen),
then sends each client's first request and admits them all, so that every
slot is busy before the window opens.  In the window each client sends its next request as soon as its
last one completes.  Every token's time is taken where the host sees it: a
first token at the engine's ``first_token_at``, a decoded token when the
iteration that made it returns.  After the window the loop runs on until
every request sent in the window has its first token; with ``--trace 1``
two traced sub-windows follow (``trace.py``).  Then the engine is freed and a sample of the
requests finished in the window is checked against the plain reference.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np

from .. import port, reference, trace
from ..faults import planted
from ..gen import ClosedLoop

__all__ = ["run"]


class Loop:
    """The clients and the bookkeeping of every iteration."""

    def __init__(self, eng, mix: ClosedLoop):
        self.eng, self.mix = eng, mix
        self.live: Dict[int, list] = {}   # rid -> [request, tokens seen, last token time, client]
        self.phase = "setup"
        self.iterations: List[Dict] = []
        self.gaps: Dict[str, List[float]] = {}
        self.requests: List[Dict] = []
        self.retired: List[Dict] = []
        self.seen: set = set()            # prompt lengths prefilled so far

    def submit(self, client: int) -> None:
        prompt, max_new = self.mix.next(client)
        req = self.eng.submit(prompt, max_new=max_new)
        self.live[req.rid] = [req, 0, 0.0, client]
        self.requests.append({"req": req, "phase": self.phase})

    def iterate(self) -> None:
        prefill_s = self.eng.prefill_s
        done = self.eng.run(max_steps=1)
        t = time.perf_counter()
        prefill_s = self.eng.prefill_s - prefill_s
        prefills, active, active_pos, new = [], 0, 0, 0
        gaps = self.gaps.setdefault(self.phase, [])
        for item in self.live.values():
            req, seen = item[0], item[1]
            n = len(req.out)
            if n == seen:
                continue
            if seen == 0:
                prefills.append(len(req.prompt))
                new += len(req.prompt) not in self.seen
                self.seen.add(len(req.prompt))
                item[2] = req.first_token_at
                seen = 1
            if n > seen:                       # one token from this iteration's decode step
                gaps.append(t - item[2])
                item[2] = t
                active += 1
                active_pos += len(req.prompt) + n - 1
            item[1] = n
        rows = self.eng.max_batch
        self.iterations.append({"t": t, "phase": self.phase, "prefills": prefills,
                                "prefill_s": prefill_s, "new_lengths": new,
                                "active": active, "active_pos": active_pos, "rows": rows,
                                "all_pos": active_pos + (rows - active) if active else 0})
        for req in done:
            client = self.live.pop(req.rid)[3]
            self.retired.append({"req": req, "phase": self.phase, "t": t})
            self.submit(client)

    def run_until(self, deadline: float) -> float:
        while True:
            self.iterate()
            t = self.iterations[-1]["t"]
            if t >= deadline:
                return t


def _allocator(ctx) -> Dict[str, int]:
    """The caching allocator's retries and device allocations so far."""
    if not ctx.cuda:
        return {"retries": 0, "mallocs": 0}
    import torch
    st = torch.cuda.memory_stats()
    return {"retries": int(st.get("num_alloc_retries", 0)),
            "mallocs": int(st.get("num_device_alloc", 0))}


def _window_notes(iterations: List[Dict], alloc: Dict[str, int]) -> List[str]:
    """What moves the window's host time, printed with each run: the
    spread of its iterations' seconds, the prefill rate of lengths first
    seen in the window against lengths seen before (iterations with one
    prefill), and the allocator's retries and device allocations."""
    its = [i for i in iterations if i["phase"] == "window"]
    if len(its) < 2:
        return []
    dts = sorted(b["t"] - a["t"] for a, b in zip(its, its[1:]))
    pick = lambda q: dts[min(len(dts) - 1, int(q * len(dts)))]  # noqa: E731
    notes = [f"window iterations: {len(its)}, host s median {pick(0.5)!r}, p99 {pick(0.99)!r}, "
             f"max {dts[-1]!r}",
             f"allocator in the window: {alloc['retries']} retries, {alloc['mallocs']} device "
             "allocations"]
    for label, new in (("first seen", 1), ("seen before", 0)):
        one = [i for i in its if len(i["prefills"]) == 1 and i["new_lengths"] == new]
        if one:
            ms = 1e3 * sum(i["prefill_s"] for i in one) / (sum(i["prefills"][0] for i in one) / 1e3)
            notes.append(f"prefill of a length {label}: {len(one)} single prefills, "
                         f"{ms!r} ms/ktok")
    return notes


def _engine_counters(eng) -> Dict[str, float]:
    return {"prefill_s": eng.prefill_s, "decode_s": eng.decode_s,
            "decode_steps": eng.decode_steps, "tokens_out": eng.tokens_out}


def run(ctx) -> Dict:
    from repro_torch.serve.engine import ServeEngine
    fam, s, mix_cfg = ctx.family, ctx.spec, ctx.traffic
    record: Dict = {"spec": s, "family": ctx.cfg["family"]}
    with planted(fam, ctx.fault):
        arch = fam.arch_config(ctx.cfg, s, ctx.config_name)
        ctx.mark("imported")
        model = port.load_model(fam, arch, s, ctx.seed, ctx.device)
        ctx.sync()
        ctx.mark("weights")
        eng = ServeEngine(arch, model, max_batch=int(mix_cfg["slots"]),
                          max_seq=int(mix_cfg["max_seq"]), device=ctx.device)
        mix = ClosedLoop(mix_cfg, s.vocab, ctx.seed)
        warm = mix.warm_lengths(int(mix_cfg["warm_step"]))
        for n in warm:
            eng.submit([1] * n, max_new=1)
            eng.run()
        ctx.mark("lengths warmed")
        loop = Loop(eng, mix)
        loop.seen.update(warm)
        for c in range(loop.mix.clients):
            loop.submit(c)
        loop.iterate()
        ctx.mark("slots filled")
        for _ in range(int(mix_cfg["warm_iterations"]) - 1):
            loop.iterate()
        ctx.sync()

        gc.collect()
        gc.freeze()      # set-up's objects out of the collector's way in the window
        loop.phase = "window"
        t_open = time.perf_counter()
        before, alloc = _engine_counters(eng), _allocator(ctx)
        t_close = loop.run_until(t_open + ctx.seconds)
        after = _engine_counters(eng)
        alloc = {k: v - alloc[k] for k, v in _allocator(ctx).items()}
        sent = [r["req"] for r in loop.requests if r["phase"] == "window"]
        loop.phase = "after"
        deadline = t_close + float(mix_cfg["wait_seconds"])
        while any(r.first_token_at is None for r in sent) and time.perf_counter() < deadline:
            loop.iterate()
        if ctx.trace:
            for key, host_ops in (("trace", False), ("trace_ops", True)):
                loop.phase = key
                with trace.traced(record, key, host_ops):
                    loop.run_until(time.perf_counter() + float(mix_cfg["trace_seconds"]))
        record["memory_peak_bytes"] = ctx.memory_peak()
        ctx.mark("window and trace done")

        finished = ([r["req"] for r in loop.retired if r["phase"] == "window"]
                    or [r["req"] for r in loop.retired])
        rng = np.random.default_rng([ctx.seed, 3])
        longest = max(finished, key=lambda r: len(r.prompt) + len(r.out))
        others = [r for r in finished if r is not longest]
        k = min(len(others), int(mix_cfg["check_requests"]) - 1)
        picked = [longest] + [others[i] for i in rng.choice(len(others), k, replace=False)]
        seqs = [(list(r.prompt), list(r.out)) for r in picked]

        record.update(
            window={"open": t_open, "close": t_close, "seconds": t_close - t_open},
            engine={k: after[k] - before[k] for k in after},
            iterations=loop.iterations, gaps=loop.gaps,
            requests=[{"submitted": r["req"].submitted_at, "first": r["req"].first_token_at,
                       "prompt": len(r["req"].prompt), "out": len(r["req"].out)}
                      for r in loop.requests],
            attempted=len(sent), failed=sum(r.first_token_at is None for r in sent),
            bases=_window_notes(loop.iterations, alloc))
        del loop, eng, model, finished, others, picked, sent
    gc.unfreeze()
    gc.collect()
    ctx.free()

    got = reference.served_gaps(fam, s, ctx.seed, seqs, ctx.device, control=ctx.control)
    ctx.mark("reference done")
    record["readings"] = {"served_logit_gap": got["served_logit_gap"]}
    record["checked_tokens"] = got["tokens"]
    record["checked_requests"] = len(seqs)
    if ctx.control:
        record["control"] = {"served_logit_gap": got["control_logit_gap"]}
    return record
