"""PyTorch port, the span recorder (``repro_torch/spans.py``) and its spans
in the serving engine and the training step, on the CPU: nesting and self
time; nothing recorded and no clock read while recording is off; the
engine's and the step's spans with their attributes; outputs bit-identical
with recording on and off; and spans placed on ``torch.profiler``'s clock
by the two clock pairs."""

import dataclasses
import time

import pytest
import torch

from repro_torch import spans
from repro_torch.configs.base import smoke_of
from repro_torch.models.model import bundle_for
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedule import constant
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.step import make_train_state, make_train_step

CPU = torch.device("cpu")
PROMPTS = ([3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7, 9], [3, 2])


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with recording off."""
    if spans.on:
        spans.stop()
    yield
    if spans.on:
        spans.stop()


@pytest.fixture(scope="module")
def demo():
    cfg = dataclasses.replace(smoke_of("lidc-demo"), dtype="float32")
    return cfg, bundle_for(cfg).init(cfg, 0, device=CPU)


def _serve(cfg, params, record: bool):
    """Four requests on two slots, run to the end; the requests, the
    engine, and the recorder's output (None when off)."""
    eng = ServeEngine(cfg, params, max_batch=2, max_seq=32, device=CPU)
    reqs = [eng.submit(p, max_new=3 + i) for i, p in enumerate(PROMPTS)]
    if record:
        spans.start()
    eng.run()
    return reqs, eng, spans.stop() if record else None


def _batch(cfg, rows=4, seq=16):
    g = torch.Generator().manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, (rows, seq + 1), generator=g, dtype=torch.int32)
    return {"tokens": tokens[:, :-1].contiguous(), "labels": tokens[:, 1:].contiguous()}


def _train(cfg, record: bool, microbatch: int = 1):
    opt = AdamW(lr=constant(1e-3))
    state = make_train_state(cfg, 0, opt, device=CPU)
    if record:
        spans.start()
    state, metrics = make_train_step(cfg, opt, microbatch=microbatch)(state, _batch(cfg))
    return state, metrics, spans.stop() if record else None


def test_spans_nest_and_give_self_time():
    spans.start()
    with spans.span("outer", k=1):
        t0 = time.perf_counter()
        with spans.span("inner"):
            time.sleep(0.002)
        t1 = time.perf_counter()
        i = spans.record("taken", t0, t1, n=2)
        spans.record("child", t0, t0 + 1e-4, parent=i)
    out = spans.stop()
    assert not spans.on and len(out["clocks"]) == 2
    s = out["spans"]
    assert [x["name"] for x in s] == ["outer", "inner", "taken", "child"]
    assert [x["parent"] for x in s] == [-1, 0, 0, 2]
    assert s[0]["attrs"] == {"k": 1} and s[2]["attrs"] == {"n": 2}
    assert all(x["start"] <= x["end"] for x in s)
    assert s[0]["start"] <= s[1]["start"] and s[1]["end"] <= s[0]["end"]
    own = spans.self_times(s)
    assert own[1] == pytest.approx(s[1]["end"] - s[1]["start"])
    assert own[2] == pytest.approx(t1 - t0 - 1e-4)
    assert own[0] == pytest.approx(s[0]["end"] - s[0]["start"]
                                   - (s[1]["end"] - s[1]["start"]) - (t1 - t0))
    assert spans.stop()["spans"] == []       # stopping again finds nothing


class _Counter:
    """A ``time`` module that counts ``perf_counter`` reads."""

    def __init__(self):
        self.reads = 0

    def perf_counter(self):
        self.reads += 1
        return time.perf_counter()


class _NoClock:
    def __getattr__(self, name):
        raise AssertionError(f"the recorder read time.{name} while off")


@pytest.mark.parametrize("record", [False, True])
def test_engine_clock_reads_with_recording_off_and_on(demo, monkeypatch, record):
    """Off, an engine run takes exactly its counters' reads (two a prefill,
    two a decode step) and never calls into the recorder; on, one more a
    sync."""
    cfg, params = demo
    clock = _Counter()
    monkeypatch.setattr(engine_mod, "time", clock)
    if not record:
        monkeypatch.setattr(spans, "time", _NoClock())
        for name in ("span", "record", "_add"):
            monkeypatch.setattr(spans, name, None)
    reqs, eng, out = _serve(cfg, params, record)
    reads = clock.reads - len(PROMPTS)                # submit's reads
    assert reads == (2 + record) * (len(PROMPTS) + eng.decode_steps)
    assert (out is None) == (not record) and not spans._spans


def test_train_step_calls_no_recorder_while_off(demo, monkeypatch):
    cfg, _ = demo
    monkeypatch.setattr(spans, "time", _NoClock())
    for name in ("span", "record", "_add"):
        monkeypatch.setattr(spans, name, None)
    _train(cfg, record=False)
    assert not spans._spans


def test_engine_spans(demo):
    cfg, params = demo
    reqs, eng, out = _serve(cfg, params, record=True)
    s = out["spans"]
    names = [x["name"] for x in s]
    its = [i for i, n in enumerate(names) if n == "engine.iteration"]
    decodes = [x for x in s if x["name"] == "engine.decode"]
    prefills = [x for x in s if x["name"] == "engine.prefill"]
    assert len(decodes) == eng.decode_steps and len(prefills) == len(PROMPTS)
    # the first iteration opens on the four queued requests and no busy slot
    assert s[its[0]]["attrs"] == {"queued": 4, "busy": 0}
    assert all(s[s[i + 1]["parent"]]["name"] == "engine.iteration" for i in its
               if names[i + 1] == "engine.admit")
    for x in prefills:
        r = reqs[x["attrs"]["rid"] - 1]
        assert x["attrs"]["tokens"] == len(r.prompt) and 0 <= x["attrs"]["slot"] < 2
        assert (x["start"], x["end"]) == (r.admitted_at, r.first_token_at)
        assert s[x["parent"]]["name"] == "engine.admit"
        assert r.submitted_at <= r.admitted_at < r.first_token_at
    syncs = [x for x in s if x["name"] == "engine.sync"]
    assert len(syncs) == len(prefills) + len(decodes)
    for x in syncs:
        p = s[x["parent"]]
        assert p["name"] in ("engine.prefill", "engine.decode") and x["end"] == p["end"]
        assert p["start"] <= x["start"] <= x["end"]
    # every decode step advances each busy slot by one token
    decoded = sum(len(r.out) - 1 for r in reqs)
    assert sum(x["attrs"]["busy"] for x in decodes) == decoded
    assert all(1 <= x["attrs"]["busy"] <= 2 for x in decodes)
    for x in decodes:
        assert s[x["parent"]]["name"] == "engine.iteration"
    assert all(o >= 0 for o in spans.self_times(s))


@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_step_spans(demo, microbatch):
    cfg, _ = demo
    _, _, out = _train(cfg, record=True, microbatch=microbatch)
    s = out["spans"]
    assert [x["name"] for x in s] == (["train.forward", "train.backward"] * microbatch
                                      + ["train.optimizer"])
    assert all(x["parent"] == -1 for x in s)
    assert all(a["end"] <= b["start"] for a, b in zip(s, s[1:]))


def test_outputs_identical_with_recording_on_and_off(demo):
    cfg, params = demo
    off, _, _ = _serve(cfg, params, record=False)
    on, _, _ = _serve(cfg, params, record=True)
    assert [r.out for r in on] == [r.out for r in off]
    s_off, m_off, _ = _train(cfg, record=False)
    s_on, m_on, _ = _train(cfg, record=True)
    assert torch.equal(m_on["loss"], m_off["loss"])
    assert all(torch.equal(a, b) for a, b in zip(s_on["params"].parameters(),
                                                  s_off["params"].parameters()))


def test_spans_map_onto_the_profilers_clock():
    """A ``record_function`` range opened inside a span lies inside it on
    the profiler's clock, once the two clock pairs map the span there."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spans.start()
        for _ in range(3):
            with spans.span("outer"):
                with record_function("inner"):
                    time.sleep(0.002)
            time.sleep(0.001)
        out = spans.stop()
    (p0, u0), (p1, u1) = out["clocks"]
    rate = (u1 - u0) / (p1 - p0)

    def ns(t):
        return u0 + (t - p0) * rate

    inner = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                   if e.name() == "inner")
    assert len(inner) == len(out["spans"]) == 3
    for (a, b), x in zip(inner, out["spans"]):
        assert ns(x["start"]) - 100e3 <= a < b <= ns(x["end"]) + 100e3
        assert b - a > 1.5e6
    assert abs(rate - 1e9) / 1e9 < 1e-3          # the pairs' drift
