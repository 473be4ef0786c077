"""PyTorch port, dense training on the CPU against the JAX package: the
losses, their gradients through the whole model under each remat policy,
one AdamW step, the schedules, microbatch accumulation and the attention
backward's plain version.

The same weights (JAX ``bundle.init``, flattened as the checkpoint flattens
them, through ``interop``) and the same numpy batches go through both.
Configs: lidc-demo-smoke, qwen2-smoke (QKV bias, head dim 8, group 7) and
qwen3-smoke (qk_norm).  Tolerances: 2e-5 in f32 (elementwise, atol = rtol),
3e-2 in bf16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _flatten
from repro.configs.base import smoke_of as jax_smoke
from repro.kernels import ref as jax_ref
from repro.models import bundle_for as jax_bundle
from repro.models import layers as JL
from repro.optim import AdamW as JAdamW
from repro.optim import constant as jconstant
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch.configs.base import smoke_of
from repro_torch.interop import _jax_key, named_to_jax, params_from_jax, params_to_jax
from repro_torch.kernels import ops, ref
from repro_torch.models import bundle_for
from repro_torch.models.model import model_module
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW, constant, warmup_cosine
from repro_torch.train.step import make_train_state, make_train_step

CPU = torch.device("cpu")
ARCHS = ["lidc-demo", "qwen2-0.5b", "qwen3-1.7b"]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _pair(arch, dtype="float32"):
    """(jax cfg, jax params, torch cfg, torch params) with equal weights."""
    jcfg = dataclasses.replace(jax_smoke(arch), dtype=dtype)
    cfg = dataclasses.replace(smoke_of(arch), dtype=dtype)
    jparams = jax_bundle(jcfg).init(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(_flatten(jparams), cfg, device=CPU)
    params.requires_grad_(True)
    return jcfg, jparams, cfg, params


def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _close(t_out, j_out, tol):
    np.testing.assert_allclose(np.asarray(t_out, np.float32), np.asarray(j_out, np.float32),
                               atol=tol, rtol=tol)


def _named_grads(params, grads):
    """The port's gradients as flattened JAX-keyed f32 numpy arrays."""
    return named_to_jax(zip((n for n, _ in params.named_parameters()), grads))


# ---------------------------------------------------------------------------
# the losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_cross_entropy_loss_matches_jax(z_loss):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 9, 37)).astype(np.float32) * 3
    labels = rng.integers(0, 37, (2, 9)).astype(np.int32)
    jl, jg = jax.value_and_grad(
        lambda x: JL.cross_entropy_loss(x, jnp.asarray(labels), z_loss))(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    loss = L.cross_entropy_loss(x, torch.tensor(labels), z_loss)
    (g,) = torch.autograd.grad(loss, x)
    _close(loss.detach(), jl, TOL["float32"])
    _close(g, jg, TOL["float32"])


@pytest.mark.parametrize("S", [512, 1024, 96])   # unchunked (S == chunk), chunked, ragged
def test_chunked_lm_loss_matches_jax(S):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, S, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 50)) / 4).astype(np.float32)
    labels = rng.integers(0, 50, (2, S)).astype(np.int32)
    jl, (jgx, jgw) = jax.value_and_grad(
        lambda a, b: JL.chunked_lm_loss(a, b, jnp.asarray(labels)), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = torch.tensor(x, requires_grad=True), torch.tensor(w, requires_grad=True)
    loss = L.chunked_lm_loss(tx, tw, torch.tensor(labels))
    gx, gw = torch.autograd.grad(loss, (tx, tw))
    _close(loss.detach(), jl, TOL["float32"])
    _close(gx, jgx, TOL["float32"])
    _close(gw, jgw, TOL["float32"])


def test_chunked_lm_loss_rounds_the_product_in_the_parameter_dtype():
    """bf16: the chunk's logits are the bf16 product cast to f32, as the
    reference's ``(xc @ w_out).astype(f32)``."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 1024, 32)).astype(np.float32)
    w = (rng.standard_normal((32, 64)) / 5).astype(np.float32)
    labels = rng.integers(0, 64, (1, 1024)).astype(np.int32)
    jl = JL.chunked_lm_loss(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                            jnp.asarray(labels))
    tl = L.chunked_lm_loss(torch.tensor(x).bfloat16(), torch.tensor(w).bfloat16(),
                           torch.tensor(labels))
    _close(tl, jl, 1e-5)


# ---------------------------------------------------------------------------
# loss_fn and every parameter's gradient
# ---------------------------------------------------------------------------

def _jax_value_and_grads(jcfg, jparams, batch, remat="none"):
    loss_fn = jax_bundle(jcfg).loss_fn
    jl, jg = jax.value_and_grad(lambda p: loss_fn(
        jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}, remat=remat))(jparams)
    return float(jl), _flatten(jg)


def _port_value_and_grads(cfg, params, batch, remat="none"):
    loss = bundle_for(cfg).loss_fn(cfg, params, {k: torch.tensor(v) for k, v in batch.items()},
                                   remat=remat)
    grads = torch.autograd.grad(loss, list(params.parameters()))
    return loss.item(), _named_grads(params, grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_every_gradient_match_jax(arch):
    jcfg, jparams, cfg, params = _pair(arch)
    batch = _batch(cfg, 2, 24)
    jl, jg = _jax_value_and_grads(jcfg, jparams, batch)
    tl, tg = _port_value_and_grads(cfg, params, batch)
    assert abs(tl - jl) <= TOL["float32"] * (1 + abs(jl))
    assert set(tg) == set(jg)
    for key in jg:
        _close(tg[key], jg[key], TOL["float32"])


def test_loss_fn_gradients_match_jax_in_bf16():
    jcfg, jparams, cfg, params = _pair("qwen3-1.7b", "bfloat16")
    batch = _batch(cfg, 2, 24)
    jl, jg = _jax_value_and_grads(jcfg, jparams, batch)
    tl, tg = _port_value_and_grads(cfg, params, batch)
    assert abs(tl - jl) <= TOL["bfloat16"] * (1 + abs(jl))
    for key in jg:
        _close(tg[key], jg[key], TOL["bfloat16"])


def test_loss_fn_over_chunked_loss_matches_jax():
    """S = 1024: the loss is chunked (two chunks of 512), attention stays
    unchunked on both sides (the reference chunks it above 1024 queries)."""
    jcfg, jparams, cfg, params = _pair("lidc-demo")
    batch = _batch(cfg, 1, 1024, seed=4)
    jl, jg = _jax_value_and_grads(jcfg, jparams, batch)
    tl, tg = _port_value_and_grads(cfg, params, batch)
    assert abs(tl - jl) <= TOL["float32"] * (1 + abs(jl))
    for key in jg:
        _close(tg[key], jg[key], TOL["float32"])


@pytest.mark.parametrize("arch", ARCHS + ["qwen3-moe-30b-a3b"])
def test_remat_policies_give_the_same_loss_and_gradients(arch):
    _, _, cfg, params = _pair(arch)
    batch = _batch(cfg, 2, 24, seed=5)
    base_l, base_g = _port_value_and_grads(cfg, params, batch, "none")
    for remat in ("full", "dots"):
        tl, tg = _port_value_and_grads(cfg, params, batch, remat)
        assert tl == base_l
        for key in base_g:
            np.testing.assert_allclose(tg[key], base_g[key], atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="remat"):
        _port_value_and_grads(cfg, params, batch, "sometimes")


class _CountMM(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the ``mm`` ops that run, forward, recomputed or gradient."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


def test_dots_policy_saves_the_products_and_recomputes_the_rest(monkeypatch):
    """In the backward pass "full" recomputes the whole block, "dots" the
    block but none of its ``x @ w`` products (both recompute attention),
    "none" nothing: counted against "none", whose backward runs only the
    gradients' products."""
    _, _, cfg, params = _pair("lidc-demo")
    tokens = torch.tensor(_batch(cfg, 1, 16)["tokens"])
    blocks = [p for n, p in params.named_parameters() if n.startswith("blocks.")]
    attention_calls = [0]
    real = ops.attention

    def attention(*a, **kw):
        attention_calls[0] += 1
        return real(*a, **kw)

    monkeypatch.setattr(ops, "attention", attention)
    in_backward = {}
    for remat in ("none", "full", "dots"):
        x = T.hidden(cfg, params, tokens, remat=remat)
        attention_calls[0] = 0
        with _CountMM() as mode:
            torch.autograd.grad(x.sum(), blocks)
        in_backward[remat] = (mode.mm, attention_calls[0])
    n = cfg.n_layers
    base_mm = in_backward["none"][0]
    assert in_backward["none"][1] == 0
    assert in_backward["full"][1] == in_backward["dots"][1] == n
    assert in_backward["full"][0] > base_mm
    assert in_backward["dots"][0] == base_mm


def test_tied_embedding_takes_its_gradient_from_both_uses():
    jcfg, jparams, cfg, params = _pair("lidc-demo")
    assert cfg.tie_embeddings
    batch = _batch(cfg, 1, 12)
    _, tg = _port_value_and_grads(cfg, params, batch)
    # the lookup alone reaches only the rows of the batch's tokens; the
    # output projection reaches every row
    unseen = np.setdiff1d(np.arange(cfg.vocab), batch["tokens"])
    assert np.abs(tg["embed/table"][unseen]).max() > 0
    _, jg = _jax_value_and_grads(jcfg, jparams, batch)
    _close(tg["embed/table"], jg["embed/table"], TOL["float32"])


def test_moe_and_hybrid_training_is_not_ported_yet():
    """Every family the port trains (the MoE family since its router has a
    backward, tests/test_torch_moe_train.py; the hybrid since its scan has
    one, tests/test_torch_hybrid_train.py; the xLSTM and the
    encoder-decoder, tests/test_torch_xlstm.py and test_torch_encdec.py)
    trains through its own module's ``loss_fn``; the name is kept from when
    the MoE and hybrid families did not train."""
    from repro_torch.models.model import TRAINED_FAMILIES
    assert set(TRAINED_FAMILIES) == {"dense", "vlm", "moe", "hybrid", "ssm", "encdec"}
    for arch in ("lidc-demo", "chameleon-34b", "qwen3-moe-30b-a3b", "zamba2-2.7b",
                 "xlstm-350m", "seamless-m4t-large-v2"):
        cfg = smoke_of(arch)
        assert cfg.family in TRAINED_FAMILIES
        assert bundle_for(cfg).loss_fn is model_module(cfg).loss_fn, arch


# ---------------------------------------------------------------------------
# AdamW and the schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_steps_match_jax(dtype):
    """Two steps on the same gradients, the clip active (the gradients'
    norm is far above 0.5): parameters, both moments and the step."""
    jcfg, jparams, cfg, params = _pair("qwen3-1.7b", dtype)
    rng = np.random.default_rng(6)
    flat = _flatten(jparams)
    grads_np = [{k: rng.standard_normal(a.shape).astype(np.float32) for k, a in flat.items()}
                for _ in range(2)]
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=0.5)
    jopt = JAdamW(lr=jwarmup_cosine(3e-3, 1, 10), **kw)
    opt = AdamW(lr=warmup_cosine(3e-3, 1, 10), **kw)
    jstate, state = jopt.init(jparams), opt.init(params)
    jtree = jax.tree_util.tree_structure(jparams)
    for g in grads_np:
        jg = jax.tree_util.tree_unflatten(jtree, [
            jnp.asarray(g[k], dtype=jcfg.dtype) for k in _flat_keys(jparams)])
        jparams, jstate, jm = jopt.update(jg, jstate, jparams)
        tg = []
        for name, p in params.named_parameters():
            key, idx = _jax_key(name)
            tg.append(torch.tensor(g[key][idx]).to(p.dtype))
        state, tm = opt.update(tg, state, params)
        _close(tm["grad_norm"], jm["grad_norm"], 1e-5)
        _close(tm["lr"], jm["lr"], 1e-6)
    assert int(state.step) == int(jstate.step) == 2
    tol = TOL[dtype] if dtype == "bfloat16" else 1e-5
    for key, want in _flatten(jparams).items():
        _close(params_to_jax(params)[key], want, tol)
    for name, jtree_m, tm_ in (("m", jstate.m, state.m), ("v", jstate.v, state.v)):
        got = named_to_jax(tm_.items())
        for key, want in _flatten(jtree_m).items():
            _close(got[key], want, 1e-5)


def _flat_keys(tree):
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_adamw_decays_only_arrays_of_two_or_more_dims_in_the_reference():
    """With zero gradients only the decay moves a parameter.  The final
    norm, (d,) in both frameworks, keeps its values; a block's norm weight
    is a row of the reference's stacked (L, d) array and decays."""
    _, _, cfg, params = _pair("qwen3-1.7b")
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    opt = AdamW(lr=constant(0.1), weight_decay=0.5)
    state = opt.init(params)
    opt.update([torch.zeros_like(p) for p in params.parameters()], state, params)
    for name, p in params.named_parameters():
        if name.startswith("final_norm"):
            assert torch.equal(p, before[name]), name
        else:
            torch.testing.assert_close(p.detach(), before[name] * (1 - 0.1 * 0.5))


def test_schedules_match_jax():
    for total, warmup in ((10, 2), (100, 5), (3, 2)):
        jlr, lr = jwarmup_cosine(3e-3, warmup, total), warmup_cosine(3e-3, warmup, total)
        for s in range(total + 3):
            _close(lr(torch.tensor(s, dtype=torch.int32)), jlr(jnp.asarray(s, jnp.int32)), 1e-6)
    _close(constant(0.25)(torch.tensor(7)), jconstant(0.25)(jnp.asarray(7)), 0)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def test_microbatches_equal_one_batch():
    cfg = dataclasses.replace(smoke_of("qwen2-0.5b"), dtype="float32")
    opt = AdamW(lr=constant(1e-3))
    batch = {k: torch.tensor(v) for k, v in _batch(cfg, 4, 16, seed=7).items()}
    states, metrics = [], []
    for mb in (1, 2):
        state = make_train_state(cfg, 0, opt, device=CPU)
        state, m = make_train_step(cfg, opt, microbatch=mb)(state, batch)
        states.append(params_to_jax(state["params"]))
        metrics.append(m)
    for k in ("loss", "grad_norm"):
        _close(metrics[1][k], metrics[0][k], TOL["float32"])
    for key in states[0]:
        _close(states[1][key], states[0][key], TOL["float32"])
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(cfg, opt, microbatch=3)(state, batch)


def test_train_step_matches_jax():
    """One whole step, port against reference, from equal weights: the
    loss, the gradients' norm, and the parameters after AdamW.  A first
    AdamW step moves each element by lr * g / (|g| + eps): +-lr where |g| is
    far above eps, a steep function of g where |g| is near it, so there the
    f32 noise of the two frameworks' gradients moves the step itself.  The
    parameters are held to 2e-5 plus 2% of one step (lr)."""
    from repro.train.step import make_train_step as jax_make_train_step
    jcfg, jparams, cfg, params = _pair("qwen3-1.7b")
    batch = _batch(cfg, 2, 16, seed=8)
    jopt, opt = JAdamW(lr=jconstant(1e-3)), AdamW(lr=constant(1e-3))
    jstate, jm = jax.jit(jax_make_train_step(jcfg, jopt))(
        {"params": jparams, "opt": jopt.init(jparams)},
        {k: jnp.asarray(v) for k, v in batch.items()})
    state, tm = make_train_step(cfg, opt)({"params": params, "opt": opt.init(params)},
                                          {k: torch.tensor(v) for k, v in batch.items()})
    _close(tm["loss"], jm["loss"], TOL["float32"])
    _close(tm["grad_norm"], jm["grad_norm"], TOL["float32"])
    got = params_to_jax(state["params"])
    for key, want in _flatten(jstate["params"]).items():
        np.testing.assert_allclose(got[key], want, rtol=TOL["float32"],
                                   atol=TOL["float32"] + 0.02 * 1e-3)


# ---------------------------------------------------------------------------
# attention backward, plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,T,H,K,hd,causal", [
    (2, 24, 24, 4, 2, 16, True),
    (1, 9, 40, 7, 1, 8, True),        # queries the last 9 of 40 keys, group 7
    (2, 17, 17, 4, 4, 32, False),
    (1, 70, 70, 8, 2, 64, True),      # a 64-row tile and a ragged tail
])
def test_attention_bwd_ref_matches_autograd_and_jax_vjp(B, S, T, H, K, hd, causal):
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd)))
    do = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o = ops.attention(tq, tk, tv, causal=causal)       # the CPU path: the plain version
    auto = torch.autograd.grad(o, (tq, tk, tv), torch.tensor(do))
    lse = ref.attention_lse_ref(tq.detach(), tk.detach(), causal=causal)
    closed = ref.attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(), o.detach(), lse,
                                   torch.tensor(do), causal=causal)
    _, vjp = jax.vjp(lambda a, b, c: jax_ref.attention_ref(a, b, c, causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    for got, want, jwant in zip(closed, auto, jgrads):
        _close(got, want, TOL["float32"])
        _close(got, jwant, TOL["float32"])


def test_attention_lse_ref_is_the_softmax_normaliser():
    rng = np.random.default_rng(10)
    q = torch.tensor(rng.standard_normal((1, 5, 4, 8)).astype(np.float32))
    k = torch.tensor(rng.standard_normal((1, 11, 2, 8)).astype(np.float32))
    lse = ref.attention_lse_ref(q, k)
    qg = q.reshape(1, 5, 2, 2, 8)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k) * 8 ** -0.5
    mask = torch.arange(11)[None, :] > torch.arange(5)[:, None] + 6
    want = torch.logsumexp(s.masked_fill(mask, -torch.inf), dim=-1).reshape(1, 4, 5)
    torch.testing.assert_close(lse, want)
