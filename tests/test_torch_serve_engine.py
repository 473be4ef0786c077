"""PyTorch port, ServeEngine: the JAX engine's tests (tests/test_serve_engine.py
and the two engine tests of tests/test_training.py) run against the port on
the CPU, plus the two engines side by side: identical greedy streams, and a
KV checkpoint taken in the JAX engine restored into the port's engine.

Weights come from the JAX ``bundle.init`` through ``interop``.
"""

import dataclasses
import sys

import jax
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _flatten
from repro.configs.base import get_config as jax_config
from repro.configs.base import smoke_of as jax_smoke
from repro.models import bundle_for as jax_bundle
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs.base import get_config, smoke_of
from repro_torch.interop import params_from_jax
from repro_torch.serve.engine import (SUPPORTED_FAMILIES, ServeEngine,
                                      UnsupportedFamilyError)

KEY = jax.random.PRNGKey(0)
CPU = torch.device("cpu")


def _engine(cfg, params, **kw):
    return ServeEngine(cfg, params, device=CPU, **kw)


@pytest.fixture(scope="module")
def demo():
    """lidc-demo at its own dtype (bf16), as the JAX engine tests run it."""
    jcfg = jax_config("lidc-demo")
    cfg = get_config("lidc-demo")
    return cfg, params_from_jax(_flatten(jax_bundle(jcfg).init(jcfg, KEY)), cfg,
                                device=CPU)


@pytest.fixture(scope="module")
def smoke_f32():
    """lidc-demo-smoke in f32, with the JAX params beside the port's."""
    jcfg = dataclasses.replace(jax_smoke("lidc-demo"), dtype="float32")
    cfg = dataclasses.replace(smoke_of("lidc-demo"), dtype="float32")
    jparams = jax_bundle(jcfg).init(jcfg, KEY)
    return jcfg, jparams, cfg, params_from_jax(_flatten(jparams), cfg, device=CPU)


# ---------------------------------------------------------------------------
# tests/test_serve_engine.py, on the port
# ---------------------------------------------------------------------------

def test_unsupported_family_raises_typed_error(demo):
    cfg, params = demo
    moe_cfg = dataclasses.replace(cfg, family="moe")
    with pytest.raises(UnsupportedFamilyError) as exc:
        _engine(moe_cfg, params, max_batch=1, max_seq=32)
    assert exc.value.family == "moe"
    assert "moe" in str(exc.value)
    assert isinstance(exc.value, ValueError)
    assert cfg.family in SUPPORTED_FAMILIES


def test_slot_exhaustion_with_nonempty_queue(demo):
    cfg, params = demo
    eng = _engine(cfg, params, max_batch=2, max_seq=64)
    rng = np.random.default_rng(1)
    reqs = [eng.submit(list(rng.integers(0, cfg.vocab, 5)), max_new=4)
            for _ in range(6)]
    assert len(eng.queue) == 6 and all(s is None for s in eng.slots)
    done = eng.run()
    assert len(done) == 6 and all(r.done for r in reqs)
    assert all(len(r.out) == 4 for r in reqs)
    assert not eng.queue and all(s is None for s in eng.slots)


def test_eos_mid_batch_frees_slot_for_queued_request(demo):
    cfg, params = demo
    prompt = [3, 1, 4, 1, 5]
    probe = _engine(cfg, params, max_batch=1, max_seq=64)
    r = probe.submit(prompt, max_new=6)
    probe.run()
    eos = r.out[1]

    eng = _engine(cfg, params, max_batch=1, max_seq=64)
    r1 = eng.submit(prompt, max_new=10, eos=eos)
    r2 = eng.submit([7, 8, 9], max_new=3)
    done = eng.run()
    assert [d.rid for d in done] == [r1.rid, r2.rid]
    assert r1.out[-1] == eos and len(r1.out) == 2
    assert len(r2.out) == 3
    assert eng.decode_steps == 3


def test_eos_on_prefill_token_frees_slot_immediately(demo):
    cfg, params = demo
    prompt = [11, 12, 13]
    probe = _engine(cfg, params, max_batch=1, max_seq=64)
    first = probe.submit(prompt, max_new=4)
    probe.run()
    eos = first.out[0]

    eng = _engine(cfg, params, max_batch=1, max_seq=64)
    r = eng.submit(prompt, max_new=8, eos=eos)
    done = eng.run()
    assert done == [r] and r.out == [eos]
    assert eng.decode_steps == 0


def test_max_new_zero_finishes_without_slot(demo):
    cfg, params = demo
    eng = _engine(cfg, params, max_batch=1, max_seq=32)
    r = eng.submit([1, 2, 3], max_new=0)
    assert r.done and r.out == [] and not eng.queue
    assert eng.run() == []
    assert eng.tokens_out == 0


def test_max_new_one_emits_exactly_one_token(demo):
    cfg, params = demo
    eng = _engine(cfg, params, max_batch=1, max_seq=32)
    r = eng.submit([1, 2, 3], max_new=1)
    done = eng.run()
    assert done == [r] and len(r.out) == 1
    assert eng.decode_steps == 0
    assert r.first_token_at >= r.submitted_at


def test_priority_orders_admission(demo):
    cfg, params = demo
    eng = _engine(cfg, params, max_batch=1, max_seq=32)
    lo = eng.submit([1, 2], max_new=2, priority=0)
    hi = eng.submit([3, 4], max_new=2, priority=5)
    done = eng.run()
    assert [d.rid for d in done] == [hi.rid, lo.rid]


def test_greedy_decode_survives_kv_checkpoint_restore(demo):
    cfg, params = demo
    prompt = [2, 7, 1, 8, 2, 8]
    max_new = 10

    solo = _engine(cfg, params, max_batch=1, max_seq=64)
    want = solo.submit(prompt, max_new=max_new)
    solo.run()

    a = _engine(cfg, params, max_batch=2, max_seq=64)
    r = a.submit(prompt, max_new=max_new)
    a._admit()
    for _ in range(3):
        a.step()
    assert 0 < len(r.out) < max_new
    state = a.kv_checkpoint(r)

    b = _engine(cfg, params, max_batch=2, max_seq=64)
    restored = b.restore(state)
    assert restored.out == r.out
    b.run()
    assert restored.done
    assert restored.out == want.out


def test_restore_rejects_when_full(demo):
    cfg, params = demo
    a = _engine(cfg, params, max_batch=1, max_seq=64)
    r = a.submit([1, 2, 3], max_new=8)
    a._admit()
    a.step()
    state = a.kv_checkpoint(r)
    b = _engine(cfg, params, max_batch=1, max_seq=64)
    b.submit([4, 5, 6], max_new=8)
    b._admit()
    with pytest.raises(RuntimeError, match="no free slot"):
        b.restore(state)


# ---------------------------------------------------------------------------
# the engine tests of tests/test_training.py, on the port
# ---------------------------------------------------------------------------

def test_serve_engine_continuous_batching(demo):
    cfg, params = demo
    eng = _engine(cfg, params, max_batch=2, max_seq=64)
    rng = np.random.default_rng(0)
    for _ in range(5):
        eng.submit(list(rng.integers(0, cfg.vocab, 6)), max_new=5)
    done = eng.run()
    assert len(done) == 5
    assert all(len(r.out) >= 5 for r in done)
    assert eng.tokens_out > 0


def test_serve_engine_matches_single_request(demo):
    """Batched continuous decoding == one-at-a-time decoding (greedy)."""
    cfg, params = demo
    prompts = [[1, 2, 3, 4], [7, 8, 9, 10, 11], [42, 5]]
    solo_outs = []
    for p in prompts:
        eng = _engine(cfg, params, max_batch=1, max_seq=32)
        r = eng.submit(p, max_new=6)
        eng.run()
        solo_outs.append(r.out)
    eng = _engine(cfg, params, max_batch=3, max_seq=32)
    reqs = [eng.submit(p, max_new=6) for p in prompts]
    eng.run()
    for r, want in zip(reqs, solo_outs):
        assert r.out == want


# ---------------------------------------------------------------------------
# the two engines side by side
# ---------------------------------------------------------------------------

def test_port_and_jax_engines_emit_identical_streams(smoke_f32):
    jcfg, jparams, cfg, params = smoke_f32
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (3, 9, 5, 12)]
    streams = []
    for eng in (JaxServeEngine(jcfg, jparams, max_batch=2, max_seq=32),
                _engine(cfg, params, max_batch=2, max_seq=32)):
        reqs = [eng.submit(p, max_new=7, priority=i % 2) for i, p in enumerate(prompts)]
        done = eng.run()
        streams.append(([r.rid for r in done], [r.out for r in reqs], eng.decode_steps))
    assert streams[0] == streams[1]


def test_engines_emit_identical_streams_on_chameleon_smoke():
    """The vlm family (chameleon's backbone on the dense decoder, qk-norm
    on) in f32: both engines emit the same greedy streams."""
    jcfg = dataclasses.replace(jax_smoke("chameleon-34b"), dtype="float32")
    cfg = dataclasses.replace(smoke_of("chameleon-34b"), dtype="float32")
    assert cfg.family == "vlm" and cfg.qk_norm and cfg.family in SUPPORTED_FAMILIES
    jparams = jax_bundle(jcfg).init(jcfg, KEY)
    params = params_from_jax(_flatten(jparams), cfg, device=CPU)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (4, 11, 6)]
    streams = []
    for eng in (JaxServeEngine(jcfg, jparams, max_batch=2, max_seq=32),
                _engine(cfg, params, max_batch=2, max_seq=32)):
        reqs = [eng.submit(p, max_new=6) for p in prompts]
        done = eng.run()
        streams.append(([r.rid for r in done], [r.out for r in reqs], eng.decode_steps))
    assert streams[0] == streams[1]


def test_jax_kv_checkpoint_restores_into_port(smoke_f32):
    """Checkpoint mid-decode in the JAX engine, restore in the port's engine:
    the stream continues exactly as uninterrupted JAX decode."""
    jcfg, jparams, cfg, params = smoke_f32
    prompt, max_new = [5, 3, 9, 1, 4, 4, 2], 9
    solo = JaxServeEngine(jcfg, jparams, max_batch=1, max_seq=32)
    want = solo.submit(prompt, max_new=max_new)
    solo.run()

    a = JaxServeEngine(jcfg, jparams, max_batch=2, max_seq=32)
    r = a.submit(prompt, max_new=max_new)
    a._admit()
    for _ in range(4):
        a.step()
    b = _engine(cfg, params, max_batch=2, max_seq=32)
    restored = b.restore(a.kv_checkpoint(r))
    assert restored.out == r.out
    b.run()
    assert restored.done and restored.out == want.out


def test_engine_without_device_needs_cuda(demo, monkeypatch):
    cfg, params = demo
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params, max_batch=1, max_seq=16)


def test_serve_cli_on_cpu(monkeypatch, capsys):
    from repro_torch.launch import serve
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "lidc-demo", "--smoke",
                                      "--device", "cpu", "--requests", "3",
                                      "--max-new", "4", "--max-batch", "2"])
    serve.main()
    out = capsys.readouterr().out
    assert "requests=3 tokens=12" in out and "device=cpu" in out


@pytest.mark.parametrize("n", [14, 15, 16, 17])
def test_prompt_that_fills_max_seq_finishes_at_prefill(smoke_f32, n):
    """A prompt of max_seq tokens leaves no cache position for the next
    token's key: the port emits the first token only (the JAX engine's
    first) and frees the slot; shorter prompts decode as in JAX, and a
    longer one is refused by both engines."""
    jcfg, jparams, cfg, params = smoke_f32
    prompt = list(range(1, n + 1))
    jax_eng = JaxServeEngine(jcfg, jparams, max_batch=2, max_seq=16)
    eng = _engine(cfg, params, max_batch=2, max_seq=16)
    jr, r = jax_eng.submit(prompt, max_new=4), eng.submit(prompt, max_new=4)
    if n > 16:
        with pytest.raises(Exception):
            jax_eng.run()
        with pytest.raises(ValueError, match="exceeds max_seq"):
            eng.run()
        return
    jax_eng.run()
    done = eng.run()
    if n == 16:
        assert done == [r] and r.done and r.out == jr.out[:1]
        assert eng.decode_steps == 0
        assert eng.slots == [None, None] and eng.cache["index"].tolist() == [0, 0]
    else:
        assert r.out == jr.out and eng.decode_steps == jax_eng.decode_steps
