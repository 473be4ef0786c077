"""The port's sharded paths on real values: a narrow model of each family
(dense, MoE and the compressed step here, the others in
``test_torch_sharded_families.py``) with DTensor parameters on a 2 x 2
``("data", "model")`` mesh of four gloo ranks on the CPU, against the same
model on one device and against the JAX package.

The rules are the production ones at a model axis of 2 with tensor
parallelism and FSDP forced on (``rules_for(..., force_tp=True,
fsdp=True)``): the vocab, the heads (or, where the KV heads do not divide
the model axis, the head dim), the experts and the FSDP dim split, so the
vocab-split embedding and loss, attention's KV-head cut, the MoE block's
explicit collectives, the xLSTM's regions, ``shard``'s gradient layout and
the decode cache's writes and attention all run on values.  Per family:

* the loss and every gradient of a training step's loss (batch 2 x 8);
* the last logits of a prefill of 2 x 6 tokens and of two decode steps
  after it, the cache laid out as the dry run lays it (``cache_pspecs``);
* where the family keeps an attention cache, the same at batch 1 with the
  cache's positions split over ``data`` (the long-context layout), the
  prompt crossing the split: the decode merges the ranks' partial results.

f32, 2e-5 (atol = rtol).  The JAX side runs in this process; the ranks get
its weights as numpy arrays and return rank 0's whole tensors.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.ckpt.checkpoint import _flatten
from repro.configs.base import smoke_of as jax_smoke
from repro.models import bundle_for as jax_bundle
from repro.train.step import make_prefill as jax_make_prefill
from torch_ranks import spawn

TOL = 2e-5
B, S, PROMPT, MAX_SEQ, FRAMES = 2, 8, 6, 8, 8

# (arch, config overrides): what each case's layout exercises; the other
# families are in test_torch_sharded_families.py
CASES = [
    ("qwen3-1.7b", {}),                       # KV heads split with the query heads
    ("mistral-large-123b", {"n_kv_heads": 1}),   # 1 KV head over 2 ranks: the head dim splits
    # experts over the model axis; a capacity that drops nothing, so that
    # the sharded branch's per-shard dispatch is the one-device dispatch
    ("qwen3-moe-30b-a3b", {"capacity_factor": 8.0}),
]
KV_CACHE = {"dense", "moe", "hybrid", "encdec"}


def _cfgs(arch, overrides):
    from repro_torch.configs.base import smoke_of
    jcfg = dataclasses.replace(jax_smoke(arch), dtype="float32", **overrides)
    cfg = dataclasses.replace(smoke_of(arch), dtype="float32", **overrides)
    return jcfg, cfg


def _inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 3)).astype(np.int32)
    out = {"tokens": toks[:, :s], "labels": toks[:, 1:s + 1], "next": toks[:, s:s + 2]}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((b, FRAMES, cfg.d_model)).astype(np.float32)
    return out


def _jax_side(jcfg, flat_params, train, serves):
    """The JAX package's loss and gradients on ``train`` and, for each of
    ``serves``, the prefill's and two decode steps' last logits."""
    jb = jax_bundle(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, flat_params)
    batch = {k: jnp.asarray(train[k]) for k in ("tokens", "labels", "frames") if k in train}
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: jb.loss_fn(jcfg, p, b)))(jparams,
                                                                                  batch)
    out = {"loss": np.asarray(loss), "grads": {k: np.asarray(v)
                                               for k, v in _flatten(grads).items()}}
    prefill = jax.jit(functools.partial(jax_make_prefill(jcfg), max_seq=MAX_SEQ))
    step = jax.jit(functools.partial(jb.decode_step, jcfg))
    for name, inp in serves.items():
        jin = {k: jnp.asarray(inp[k]) for k in ("tokens", "frames") if k in inp}
        logits, cache = prefill(jparams, jin)
        got = [np.asarray(logits[:, -1])]
        for i in range(2):
            logits, cache = step(jparams, cache, jnp.asarray(inp["next"][:, i:i + 1]))
            got.append(np.asarray(logits[:, -1]))
        out[name] = got
    return out


def _port_side(cfg, named, train, serves, mesh=None):
    """The port's loss, gradients (JAX-keyed) and serving logits, as
    ``_jax_side`` gives them: on one device, or with ``mesh`` on DTensor
    parameters and inputs under the production rules (this rank's whole
    tensors)."""
    import contextlib

    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.interop import named_to_jax, params_from_jax
    from repro_torch.launch.dryrun import batch_pspec, cache_pspecs
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models import bundle_for
    from repro_torch.models.sharding import (_piece, contiguous_strides, param_pspecs,
                                             placements, use_mesh, use_rules)
    from repro_torch.train.step import make_prefill, make_serve_step

    def laid_out(t, spec):
        if mesh is None:
            return t
        return DTensor.from_local(_piece(t, spec, mesh).clone(), mesh, placements(spec, mesh),
                                  run_check=False, shape=t.shape,
                                  stride=contiguous_strides(t.shape))

    def whole(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).detach().float().numpy()

    def tensors(inp, keys):
        return {k: torch.from_numpy(np.ascontiguousarray(inp[k])) for k in keys if k in inp}

    def under(long_ctx):
        if mesh is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(use_mesh(mesh))
        stack.enter_context(use_rules(rules_for(cfg, model_axis=2, fsdp=True, force_tp=True,
                                                seq_shard_cache=long_ctx)))
        stack.enter_context(implicit_replication())
        return stack

    def serve(params, inp, long_ctx):
        """The prefill's and two decode steps' last logits, the cache laid
        out between them as the dry run lays out a decode cell's."""
        ins = {k: laid_out(v, batch_pspec(k, v)) for k, v in tensors(inp, ("tokens",
                                                                           "frames")).items()}
        logits, cache = make_prefill(cfg)(params, ins, max_seq=MAX_SEQ)
        got = [whole(logits[:, -1])]
        if mesh is not None:
            cache = {k: v.full_tensor() if isinstance(v, DTensor) else v
                     for k, v in cache.items()}
            specs = cache_pspecs(cfg, cache, long_context=long_ctx)
            cache = {k: laid_out(v, specs[k]) for k, v in cache.items()}
        step = make_serve_step(cfg)
        for i in range(2):
            tok = torch.from_numpy(np.ascontiguousarray(inp["next"][:, i:i + 1]))
            logits, cache = step(params, cache, laid_out(tok, batch_pspec("tokens", tok)))
            got.append(whole(logits[:, -1]))
        return got

    bundle = bundle_for(cfg)
    params = params_from_jax(named, cfg, device=torch.device("cpu"))
    out = {}
    with under(False):
        if mesh is not None:
            specs = param_pspecs(params)
            for name, p in list(params.named_parameters()):
                owner, _, leaf = name.rpartition(".")
                mod = params.get_submodule(owner) if owner else params
                setattr(mod, leaf, torch.nn.Parameter(laid_out(p.detach(), specs[name])))
            out["split"] = sorted(name for name, p in params.named_parameters()
                                  if any(pl.is_shard() for pl in p.placements))
        params.requires_grad_(True)
        batch = {k: laid_out(v, batch_pspec(k, v))
                 for k, v in tensors(train, ("tokens", "labels", "frames")).items()}
        loss = bundle.loss_fn(cfg, params, batch)
        grads = torch.autograd.grad(loss, list(params.parameters()))
        out["loss"] = whole(loss)
        out["grads"] = named_to_jax((name, torch.from_numpy(whole(g))) for (name, _), g in
                                    zip(params.named_parameters(), grads))
    with torch.no_grad():
        for name, inp in serves.items():
            with under(name == "serve_long"):
                out[name] = serve(params, inp, name == "serve_long")
    return out


def _rank(rank, n, arch, overrides, named, train, serves):
    from torch.distributed.device_mesh import init_device_mesh
    _, cfg = _cfgs(arch, overrides)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = _port_side(cfg, named, train, serves, mesh)
    return out if rank == 0 else None


@pytest.mark.parametrize("arch,overrides", CASES, ids=[a for a, _ in CASES])
def test_sharded_model_matches_one_device_and_jax(arch, overrides, tmp_path):
    check_case(arch, overrides, tmp_path)


def check_case(arch, overrides, tmp_path):
    """One family's case: the sharded and the one-device port against JAX,
    and against each other."""
    jcfg, cfg = _cfgs(arch, overrides)
    tree = jax.tree_util.tree_map(np.asarray, jax_bundle(jcfg).init(jcfg, jax.random.PRNGKey(0)))
    named = {k: np.asarray(v) for k, v in _flatten(tree).items()}
    train = _inputs(cfg, B, S, 1)
    serves = {"serve": _inputs(cfg, B, PROMPT, 2)}
    if cfg.family in KV_CACHE:
        serves["serve_long"] = _inputs(cfg, 1, PROMPT, 3)
    got = {"sharded": spawn(_rank, 4, tmp_path, arch, overrides, named, train, serves,
                            timeout=300)[0],
           "single": _port_side(cfg, named, train, serves)}
    want = _jax_side(jcfg, tree, train, serves)

    assert got["sharded"]["split"], "no parameter is split over the mesh"
    for side in ("single", "sharded"):
        res = got[side]
        np.testing.assert_allclose(res["loss"], want["loss"], atol=TOL, rtol=TOL,
                                   err_msg=f"{side} loss")
        assert sorted(res["grads"]) == sorted(want["grads"])
        for k, g in want["grads"].items():
            np.testing.assert_allclose(res["grads"][k], g, atol=TOL, rtol=TOL,
                                       err_msg=f"{side} gradient {k}")
        for name in serves:
            for i, (a, b) in enumerate(zip(res[name], want[name])):
                np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL,
                                           err_msg=f"{side} {name} logits {i}")
    for k in want["grads"]:
        np.testing.assert_allclose(got["sharded"]["grads"][k], got["single"]["grads"][k],
                                   atol=TOL, rtol=TOL, err_msg=f"sharded vs one device {k}")


def _compress_rank(rank, n, named, train):
    """The compressed pod step on a (2, 1, 2) ("pod", "data", "model")
    mesh: on DTensor parameters under the rules (each pod's part of the
    gradient of the global mean loss, scaled and summed in int8 by
    ``_compressed_over_pods``), and on plain parameters, each rank holding
    its pod's rows (the per-pod step that matches the reference's)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.interop import params_from_jax, params_to_jax
    from repro_torch.launch.dryrun import batch_pspec
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models.sharding import (_piece, contiguous_strides, param_pspecs,
                                             placements, use_mesh, use_rules)
    from repro_torch.optim import AdamW, constant
    from repro_torch.train.step import make_train_step

    _, cfg = _cfgs(*COMPRESS_CASE)
    mesh = init_device_mesh("cpu", (2, 1, 2), mesh_dim_names=("pod", "data", "model"))
    opt = AdamW(lr=constant(1e-3))

    def laid_out(t, spec):
        return DTensor.from_local(_piece(t, spec, mesh).clone(), mesh, placements(spec, mesh),
                                  run_check=False, shape=t.shape,
                                  stride=contiguous_strides(t.shape))

    tokens = {k: torch.from_numpy(np.ascontiguousarray(train[k])) for k in ("tokens", "labels")}
    out = {}
    params = params_from_jax(named, cfg, device=torch.device("cpu")).requires_grad_(True)
    pod = mesh.get_local_rank("pod")
    rows = {k: v[pod * (B // 2):(pod + 1) * (B // 2)] for k, v in tokens.items()}
    state, m = make_train_step(cfg, opt, compress_pods=True, mesh=mesh)(
        {"params": params, "opt": opt.init(params)}, rows)
    out["plain"] = {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
                    "params": params_to_jax(state["params"])}

    params = params_from_jax(named, cfg, device=torch.device("cpu"))
    rules = rules_for(cfg, model_axis=2, fsdp=True, force_tp=True)
    with use_mesh(mesh), use_rules(rules), implicit_replication():
        specs = param_pspecs(params)
        for name, p in list(params.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            mod = params.get_submodule(owner) if owner else params
            setattr(mod, leaf, torch.nn.Parameter(laid_out(p.detach(), specs[name])))
        batch = {k: laid_out(v, batch_pspec(k, v)) for k, v in tokens.items()}
        state, m = make_train_step(cfg, opt, compress_pods=True, mesh=mesh)(
            {"params": params, "opt": opt.init(params)}, batch)
        whole = {name: p.full_tensor().detach() for name, p in state["params"].named_parameters()}
    for name, p in params.named_parameters():
        owner, _, leaf = name.rpartition(".")
        mod = params.get_submodule(owner) if owner else params
        setattr(mod, leaf, torch.nn.Parameter(whole[name]))
    out["sharded"] = {"loss": float(m["loss"].full_tensor()),
                      "grad_norm": float(m["grad_norm"].full_tensor()),
                      "params": params_to_jax(params)}
    return out if rank == 0 else None


COMPRESS_CASE = ("qwen3-1.7b", {})


def test_compressed_pod_step_on_dtensors_matches_the_per_pod_step(tmp_path):
    """``make_train_step(compress_pods=True)`` on DTensors (the dry run's
    ``--compress`` cells) against the same step on plain tensors, each pod
    on its own rows, which ``test_torch_distributed.py`` holds against the
    reference's: the loss at 2e-5, the gradient norm (of the int8-summed
    gradients: a pod part scaled wrongly would double it) at 1e-4, and
    every parameter's update within three int8 quanta of its largest, as
    that test holds the port to JAX (the two sides' f32 sums differ in the
    last bits, which may round an element to the neighbouring integer).
    Each pod's gradient is quantized whole, with the reference's scales: a
    rank's shard quantized alone flips the first AdamW step's sign on 1-10 %
    of the elements."""
    jcfg, cfg = _cfgs(*COMPRESS_CASE)
    tree = jax.tree_util.tree_map(np.asarray, jax_bundle(jcfg).init(jcfg, jax.random.PRNGKey(0)))
    named = {k: np.asarray(v) for k, v in _flatten(tree).items()}
    got = spawn(_compress_rank, 4, tmp_path, named, _inputs(cfg, B, S, 4), timeout=300)[0]
    plain, sharded = got["plain"], got["sharded"]
    np.testing.assert_allclose(sharded["loss"], plain["loss"], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(sharded["grad_norm"], plain["grad_norm"], rtol=1e-4)
    assert set(sharded["params"]) == set(plain["params"])
    for key, p in plain["params"].items():
        d_plain, d_sharded = p - named[key], sharded["params"][key] - named[key]
        err = np.max(np.abs(d_sharded - d_plain)) / np.max(np.abs(d_plain))
        assert err <= 3 / 127, f"{key}: {err:.3e}"
