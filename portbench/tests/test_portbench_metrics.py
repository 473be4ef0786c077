"""The end-to-end readers take every request and every gap of the window:
a stall planted in a synthetic timeline moves the rate and the tail."""

import pytest

from portbench import harness, yardstick
from portbench.families import dense

S = dense.spec_of(harness.load_json(harness.HERE / "configs" / "qwen3-1.7b.json"))


def _timeline(stall_at=None, steps=400, step_s=0.05, slots=8):
    """A closed loop on ``slots`` slots: a decode token for every slot
    every step, one request finishing and its successor prefilled every
    fourth step; ``stall_at`` adds 2 s to that step."""
    t, iterations, gaps, requests = 0.0, [], [], []
    for k in range(steps):
        dt = step_s + (2.0 if k == stall_at else 0.0)
        submitted = t
        t += dt
        prefills = [1000] if k % 4 == 0 else []
        if prefills:
            requests.append({"submitted": submitted, "first": t, "prompt": 1000, "out": 8})
        gaps += [dt] * slots
        iterations.append({"t": t, "phase": "window", "prefills": prefills, "active": slots,
                           "active_pos": slots * 1500, "rows": slots,
                           "all_pos": slots * 1500})
    return {"spec": S, "family": "dense", "window": {"open": 0.0, "close": t, "seconds": t},
            "iterations": iterations, "gaps": {"window": gaps}, "requests": requests,
            "engine": {"prefill_s": 1.0, "decode_s": 10.0, "decode_steps": steps}}


def _read(name, record):
    return harness.reader(name)(record)


def test_stall_moves_rate_and_tail():
    """One 2 s stall in a window of 12 steps holds up every slot's next
    token: the rate over the window falls, the gap tail becomes the stall,
    and the request waiting on that step has the longest first token."""
    calm, stalled = _timeline(steps=12), _timeline(steps=12, stall_at=4)
    assert _read("serve_tok_s", stalled) < 0.3 * _read("serve_tok_s", calm)
    assert _read("itl_p95_ms.serve", calm) == pytest.approx(50.0)
    assert _read("itl_p95_ms.serve", stalled) == pytest.approx(2050.0)
    assert _read("ttft_p95_ms.serve", stalled) == pytest.approx(2050.0)
    assert _read("ttft_p95_ms.serve", calm) == pytest.approx(50.0)


def test_rate_counts_all_tokens():
    rec = _timeline(steps=100)
    tokens = 100 * 8 + 25
    assert _read("serve_tok_s", rec) == pytest.approx(tokens / rec["window"]["seconds"])


def test_percentile_is_nearest_rank():
    assert yardstick.percentile(list(range(1, 101)), 95) == 95
    assert yardstick.percentile([3.0], 95) == 3.0
    assert yardstick.percentile(list(range(1, 21)), 95) == 19


def test_ratio_readers_leave_out_what_they_cannot_read():
    rec = _timeline()
    for name in ("flash_decode_roofline", "flash_attention_infer_roofline",
                 "flash_attention_roofline", "idle_share.serve", "idle_share.train"):
        assert _read(name, rec) is None


def test_every_metric_has_a_reader():
    bench = harness.load_benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert harness.reader_path(m["name"]).is_file(), m["name"]
        assert callable(harness.reader(m["name"]))


def test_split_metric_falls_back_to_its_base_reader():
    assert harness.reader_path("idle_share.train") == harness.HERE / "metrics" / "idle_share.py"
    assert harness.reader_path("mfu.train") == harness.HERE / "metrics" / "mfu.train.py"
    rec = {"trace": {"busy_s": 3.0, "window_s": 4.0}}
    assert _read("idle_share.serve", rec) == _read("idle_share.train", rec) == 25.0
