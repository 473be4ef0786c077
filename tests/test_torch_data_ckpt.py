"""PyTorch port, around the train step, on the CPU against the JAX package:
the data streams (byte-equal), the input specs and model FLOPs, named
checkpoints in both directions (keys and values, bf16 stored as f32), a run
resumed across frameworks, and the trainer's entry points.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _flatten
from repro.ckpt.checkpoint import restore_checkpoint as jax_restore
from repro.ckpt.checkpoint import save_checkpoint as jax_save
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jax_config
from repro.configs.base import smoke_of as jax_smoke
from repro.data.pipeline import LakeCorpus as JLakeCorpus
from repro.core.names import Name
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.datalake import DataLake
from repro.models import model as jax_model
from repro.optim import AdamW as JAdamW
from repro.optim import constant as jconstant
from repro.train.step import make_train_state as jax_make_train_state
from repro.train.step import make_train_step as jax_make_train_step
from repro.train.trainer import run_training as jax_run_training
from repro_torch.ckpt import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs.base import SHAPES, ShapeConfig, get_config, smoke_of
from repro_torch.data import LakeCorpus, Prefetcher, SyntheticLM, make_pipeline
from repro_torch.interop import state_from_jax, state_to_jax
from repro_torch.lake import LakeName, MemoryLake
from repro_torch.models import input_specs, model_flops, synth_batch
from repro_torch.optim import AdamW, constant
from repro_torch.train.step import make_train_state, make_train_step, train_state_shape
from repro_torch.train.trainer import run_training

CPU = torch.device("cpu")


def _cfgs(arch, dtype=None):
    jcfg, cfg = jax_smoke(arch), smoke_of(arch)
    if dtype:
        jcfg, cfg = (dataclasses.replace(c, dtype=dtype) for c in (jcfg, cfg))
    return jcfg, cfg


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,B,S,seed", [("lidc-demo", 4, 32, 0), ("qwen3-1.7b", 3, 17, 5)])
def test_synthetic_stream_is_byte_equal_to_jax(arch, B, S, seed):
    jcfg, cfg = _cfgs(arch)
    jit, it = JSyntheticLM(jcfg, B, S, seed), SyntheticLM(cfg, B, S, seed)
    for _ in range(3):
        want, got = next(jit), next(it)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])


def test_lake_corpus_is_byte_equal_to_jax():
    """The same corpus read from the reference's lake, by name string, and
    from the port's memory lake."""
    jcfg, cfg = _cfgs("lidc-demo")
    tokens = np.random.default_rng(1).integers(0, 10_000, 5000).astype(np.int64)
    name = "/lidc/data/datasets/corpus"
    jlake, mlake = DataLake(), MemoryLake()
    jlake.put_arrays(Name.parse(name), {"tokens": tokens})
    mlake.put_arrays(LakeName.parse(name), {"tokens": tokens})
    for lake in (jlake, mlake):
        got = LakeCorpus(lake, name, cfg, 4, 64, seed=3)
        want = JLakeCorpus(jlake, name, jcfg, 4, 64, seed=3)
        for _ in range(3):
            b, w = next(got), next(want)
            assert all(np.array_equal(b[k], w[k]) and b[k].dtype == w[k].dtype for k in w)
    with pytest.raises(FileNotFoundError):
        LakeCorpus(mlake, "/lidc/data/datasets/none", cfg, 4, 64)


def test_prefetcher_yields_the_stream_as_tensors():
    _, cfg = _cfgs("lidc-demo")
    shape = ShapeConfig("custom", "train", 16, 2)
    pre = make_pipeline(cfg, shape, seed=2, prefetch=2, device=CPU)
    assert isinstance(pre, Prefetcher)
    plain = make_pipeline(cfg, shape, seed=2)
    for _ in range(4):
        got, want = next(pre), next(plain)
        for k in want:
            assert isinstance(got[k], torch.Tensor)
            assert np.array_equal(got[k].numpy(), want[k])
    pre.close()
    assert not pre.thread.is_alive()
    finite = Prefetcher(iter([{"tokens": np.arange(3)}]), depth=1)
    assert np.array_equal(next(finite)["tokens"], np.arange(3))
    with pytest.raises(StopIteration):
        next(finite)


# ---------------------------------------------------------------------------
# input specs, synthetic batches, model FLOPs
# ---------------------------------------------------------------------------

def _spec_tree(tree):
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    return tuple(tree.shape), str(tree.dtype).split(".")[-1]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen3-moe-30b-a3b", "zamba2-2.7b",
                                  "lidc-demo", "xlstm-350m", "seamless-m4t-large-v2"])
def test_input_specs_and_model_flops_match_jax(arch):
    jcfg, cfg = jax_config(arch), get_config(arch)
    small = {"small_train": ("train", 64, 2), "small_decode": ("decode", 32, 3)}
    shapes = [(JSHAPES[n], SHAPES[n]) for n in SHAPES]
    shapes += [(JShapeConfig(n, *v), ShapeConfig(n, *v)) for n, v in small.items()]
    for jshape, shape in shapes:
        assert model_flops(cfg, shape) == jax_model.model_flops(jcfg, jshape)
        if shape.kind == "decode" and shape.seq_len > 1024:
            continue   # the reference's eval_shape of a 500k cache: the same code path
        assert _spec_tree(input_specs(cfg, shape)) == _spec_tree(
            jax_model.input_specs(jcfg, jshape))


def test_synth_batch_matches_the_specs():
    jcfg, cfg = _cfgs("qwen3-1.7b")
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig("s", kind, 16, 2)
        got = synth_batch(cfg, shape, seed=1, device=CPU)
        want = jax_model.synth_batch(jcfg, JShapeConfig("s", kind, 16, 2),
                                     jax.random.PRNGKey(1))
        assert _spec_tree(got) == _spec_tree(want)
        assert int(got["tokens"].min()) >= 0 and int(got["tokens"].max()) < cfg.vocab
    for arch in ("xlstm-350m", "seamless-m4t-large-v2"):   # O(1) cells; frames, enc_len
        jcfg, cfg = jax_smoke(arch), smoke_of(arch)
        for kind in ("train", "prefill", "decode"):
            got = synth_batch(cfg, ShapeConfig("s", kind, 16, 2), seed=1, device=CPU)
            want = jax_model.synth_batch(jcfg, JShapeConfig("s", kind, 16, 2),
                                         jax.random.PRNGKey(1))
            assert _spec_tree(got) == _spec_tree(want), (arch, kind)


# ---------------------------------------------------------------------------
# checkpoints across frameworks
# ---------------------------------------------------------------------------

def _jax_state_after_a_step(jcfg, seed=0):
    jopt = JAdamW(lr=jconstant(1e-3))
    state = jax_make_train_state(jcfg, jax.random.PRNGKey(seed), jopt)
    batch = {k: jnp.asarray(v) for k, v in next(JSyntheticLM(jcfg, 2, 16, seed)).items()}
    state, _ = jax.jit(jax_make_train_step(jcfg, jopt))(state, batch)
    return state, jopt


def _port_state_after_a_step(cfg, seed=0):
    opt = AdamW(lr=constant(1e-3))
    state = make_train_state(cfg, seed, opt, device=CPU)
    batch = {k: torch.tensor(v) for k, v in next(SyntheticLM(cfg, 2, 16, seed)).items()}
    state, _ = make_train_step(cfg, opt)(state, batch)
    return state, opt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_in_the_port(dtype):
    jcfg, cfg = _cfgs("qwen3-1.7b", dtype)
    jstate, _ = _jax_state_after_a_step(jcfg)
    lake = DataLake()
    jax_save(lake, "run", 1, jstate, meta={"loss": 1.0})
    assert latest_step(lake, "run") == 1
    state, step = restore_checkpoint(lake, "run", train_state_shape(cfg, AdamW(lr=constant(0))),
                                     device=CPU)
    assert step == 1 and int(state["opt"].step) == 1
    assert state["params"].embed.table.dtype == getattr(torch, dtype)
    assert all(p.requires_grad for p in state["params"].parameters())
    want, got = _flatten(jstate), state_to_jax(state)
    assert set(got) == set(want)
    assert {"params/blocks/attn/wq", "opt/.m/blocks/attn/wq", "opt/.v/embed/table",
            "opt/.step"} <= set(got)
    for key in want:
        assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_jax(dtype):
    jcfg, cfg = _cfgs("qwen2-0.5b", dtype)
    state, _ = _port_state_after_a_step(cfg)
    lake = DataLake()
    save_checkpoint(lake, "run", 1, state, meta={"loss": 2.0})
    template = jax.eval_shape(lambda k: jax_make_train_state(jcfg, k, JAdamW(lr=jconstant(0))),
                              jax.ShapeDtypeStruct((2,), jnp.uint32))
    jstate, step = jax_restore(lake, "run", template)
    assert step == 1
    want, got = state_to_jax(state), _flatten(jstate)
    assert set(got) == set(want)
    for key in want:
        assert np.array_equal(got[key], want[key]), key
    assert lake.get_json(LakeName.parse("/lidc/data/ckpt/run/latest")) == {
        "step": 1, "run": "run", "loss": 2.0}


def test_state_interop_round_trip_and_memory_lake():
    jcfg, cfg = _cfgs("lidc-demo")
    jstate, _ = _jax_state_after_a_step(jcfg)
    state = state_from_jax(_flatten(jstate), cfg, device=CPU)
    again = state_to_jax(state)
    for key, want in _flatten(jstate).items():
        assert np.array_equal(again[key], want)
    lake = MemoryLake()
    save_checkpoint(lake, "r", 3, state)
    save_checkpoint(lake, "r", 5, state)
    assert latest_step(lake, "r") == 5
    restored, step = restore_checkpoint(lake, "r", state, step=3)
    assert step == 3 and restored["params"] is not state["params"]
    for (n, a), (_, b) in zip(restored["params"].named_parameters(),
                              state["params"].named_parameters()):
        assert torch.equal(a, b), n
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(lake, "other", state)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(lake, "r", state, step=4)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def test_run_resumes_across_frameworks():
    """The reference trains 4 steps (checkpoints at 2 and 4); from a copy of
    its lake the port resumes to step 8, the reference to step 8 from the
    other.  Both resume at step 4 and restart the stream from its seed, so
    steps 5-8 see the same batches and weights.  f32, held to 1e-4: four
    AdamW steps of f32 noise, each moving the elements with gradients near
    eps by a steep function of them (test_train_step_matches_jax)."""
    jcfg, cfg = _cfgs("lidc-demo", "float32")
    kw = dict(batch=4, seq=32, run_name="x", ckpt_every=2, seed=1)
    jlake = DataLake()
    first = jax_run_training(jcfg, steps=4, lake=jlake, **kw)
    assert first.steps_done == 4
    tlake = DataLake()
    for key in jlake.store.keys():
        tlake.store.put(key, bytes(jlake.store.get(key)))
    want = jax_run_training(jcfg, steps=8, lake=jlake, **kw)
    got = run_training(cfg, steps=8, lake=tlake, device="cpu", **kw)
    assert want.resumed_from == got.resumed_from == 4
    assert got.steps_done == 8 and len(got.losses) == 4
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4, atol=1e-4)
    assert latest_step(tlake, "x") == 8
    # and the port's final checkpoint restores in the reference
    template = jax.eval_shape(lambda k: jax_make_train_state(jcfg, k, JAdamW(lr=jconstant(0))),
                              jax.ShapeDtypeStruct((2,), jnp.uint32))
    jstate, step = jax_restore(tlake, "x", template)
    assert step == 8 and int(jstate["opt"].step) == 8


def test_run_training_on_the_cpu_checkpoints_and_stops():
    _, cfg = _cfgs("qwen3-1.7b")
    lake = MemoryLake()
    seen = []
    res = run_training(cfg, steps=6, batch=2, seq=16, lake=lake, run_name="t", ckpt_every=2,
                       device="cpu", on_step=lambda s, l: seen.append(s),
                       stop_flag=lambda: len(seen) >= 5)
    assert res.steps_done == 5 and seen == [0, 1, 2, 3, 4]
    assert all(np.isfinite(res.losses)) and res.resumed_from is None
    assert latest_step(lake, "t") == 5
    assert int(res.state["opt"].step) == 5
    again = run_training(cfg, steps=6, batch=2, seq=16, lake=lake, run_name="t",
                         ckpt_every=2, device="cpu")
    assert again.resumed_from == 5 and again.steps_done == 6 and len(again.losses) == 1


def test_run_training_needs_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training(smoke_of("lidc-demo"), steps=1)


def test_train_cli_direct_mode_and_via_lidc():
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "lidc-demo", "--smoke"]
    out = subprocess.run(base + ["--steps", "3", "--batch", "2", "--seq", "16", "--device",
                                 "cpu", "--ckpt-every", "2"],
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert "step     2 loss" in out.stdout and "done: 3 steps on cpu" in out.stdout
    out = subprocess.run(base + ["--via-lidc"], capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode == 2 and "repro_torch.runtime.fleet" in out.stderr
