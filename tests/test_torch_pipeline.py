"""PyTorch port: the GPipe schedule (``repro_torch.runtime.pipeline``) on 4
gloo ranks against the reference's ``make_pp_loss_fn`` on 4 host devices.

qwen3-1.7b smoke at 4 layers in f32 (one layer a stage), B = 8, S = 16,
``n_micro`` 4, the same weights (``interop.params_from_jax``) and batch:
the loss, each stage's block gradients and the replicated weights'
gradients (summed over the stages) at 2e-5 of each tensor's largest value;
and the loss and gradients against the port's own sequential ``loss_fn``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import smoke_of
from torch_ranks import spawn, run_jax

TOL = 2e-5
N_STAGES, N_MICRO, B, S = 4, 4, 8, 16

JAX_PP = """
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.ckpt.checkpoint import _flatten
from repro.configs.base import smoke_of
from repro.models import bundle_for
from repro.models.sharding import set_rules
from repro.runtime.pipeline import make_pp_loss_fn, make_pp_mesh

set_rules({})
cfg = dataclasses.replace(smoke_of("qwen3-1.7b"), n_layers=4, dtype="float32")
bundle = bundle_for(cfg)
params = bundle.init(cfg, jax.random.PRNGKey(0))
rng = np.random.default_rng(5)
batch = {"tokens": rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32)}
mesh = make_pp_mesh(4)
pp = make_pp_loss_fn(cfg, mesh, n_stages=4, n_micro=4)
with mesh:
    loss, grads = jax.jit(jax.value_and_grad(pp))(params, batch)
np.savez(OUT, loss=np.asarray(loss), **batch,
         **{"param:" + k: v for k, v in _flatten(params).items()},
         **{"grad:" + k: v for k, v in _flatten(grads).items()})
"""


def _cfg():
    return dataclasses.replace(smoke_of("qwen3-1.7b"), n_layers=4, dtype="float32")


def _stage_rank(rank, n, ref):
    """One stage: the pipelined loss and its gradients, and the sequential
    loss_fn's, by the reference's flat names."""
    from repro_torch.interop import _jax_key, params_from_jax
    from repro_torch.models import bundle_for
    from repro_torch.runtime.pipeline import make_pp_loss_fn, make_pp_mesh, stage_layers

    cfg = _cfg()
    arrays = {k[6:]: v for k, v in ref.items() if k.startswith("param:")}
    params = params_from_jax(arrays, cfg, device=torch.device("cpu")).requires_grad_(True)
    batch = {k: torch.from_numpy(ref[k]) for k in ("tokens", "labels")}
    mesh = make_pp_mesh(N_STAGES, device="cpu")
    layers = stage_layers(cfg, mesh, N_STAGES)
    named = [(name, p) for name, p in params.named_parameters()
             if not name.startswith("blocks.") or int(name.split(".")[1]) in layers]
    loss = make_pp_loss_fn(cfg, mesh, n_stages=N_STAGES, n_micro=N_MICRO)(params, batch)
    grads = torch.autograd.grad(loss, [p for _, p in named])
    seq_loss = bundle_for(cfg).loss_fn(cfg, params, batch)
    seq_grads = torch.autograd.grad(seq_loss, [p for _, p in named])

    def by_key(gs):   # one layer a stage: a leading dim of 1 on the block keys
        return {_jax_key(name)[0]: g.numpy()[None] if name.startswith("blocks.") else g.numpy()
                for (name, _), g in zip(named, gs)}

    return {"layers": list(layers), "loss": loss.item(), "seq_loss": seq_loss.item(),
            "grads": by_key(grads), "seq_grads": by_key(seq_grads)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    ref = run_jax(JAX_PP, N_STAGES, tmp / "jax.npz")
    return ref, spawn(_stage_rank, N_STAGES, tmp, ref)


def _close(got, want, what):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(np.asarray(got, np.float32) - want))) / scale
    assert err <= TOL, f"{what}: {err:.3e} of the largest value"


def test_pp_loss_matches_jax_on_every_stage(runs):
    ref, stages = runs
    for r, st in enumerate(stages):
        assert st["layers"] == [r]
        _close(st["loss"], ref["loss"], f"stage {r} loss")
        _close(st["loss"], st["seq_loss"], f"stage {r} loss vs sequential")


@pytest.mark.parametrize("stage", range(N_STAGES))
def test_pp_gradients_match_jax(runs, stage):
    """The stage's block gradients, its slice of the reference's stacked
    gradients, and the replicated weights' gradients, whole."""
    ref, stages = runs
    st = stages[stage]
    for key, g in st["grads"].items():
        want = ref["grad:" + key]
        if key.startswith("blocks/"):
            assert g.shape[0] == 1
            want = want[stage:stage + 1]
        _close(g, want, key)
        _close(g, st["seq_grads"][key], f"{key} vs sequential")
    assert {k for k in st["grads"] if not k.startswith("blocks/")} == {
        "embed/table", "final_norm/w"}
