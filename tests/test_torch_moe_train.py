"""PyTorch port, MoE training on the CPU against the JAX package: the
router's backward in closed form (``ref.moe_router_bwd_ref`` and the two
products) against autograd through the plain router and ``jax.vjp`` of the
reference's router chain; the registered op's backward; the MoE
``loss_fn`` (LM loss plus 0.01 x the Switch load-balance term) and every
gradient under each remat policy, with capacity drops and in bf16; one
AdamW step and a microbatched step; a ``run_training`` run resumed across
frameworks; and a ``qwen3-1.7b-smoke`` train job (the reference resolves
it to the MoE smoke) killed on one framework's pod and resumed on the
other's.

Weights come from the JAX ``bundle.init`` through ``interop``, inputs from
numpy seeds.  Tolerances: 2e-5 in f32 (elementwise, atol = rtol), 3e-2 in
bf16.  A bf16 x's gradient is compared in f32 before its cast to bf16
(values that agree to 2e-5 may round to neighbouring bf16 values), and
after the cast at the bf16 tolerance.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _flatten
from repro.ckpt.checkpoint import restore_checkpoint as jax_restore
from repro.configs.base import smoke_of as jax_smoke
from repro.datalake import DataLake
from repro.kernels import ref as jref
from repro.models import bundle_for as jax_bundle
from repro.optim import AdamW as JAdamW
from repro.optim import constant as jconstant
from repro.train.step import make_train_state as jax_make_train_state
from repro.train.step import make_train_step as jax_make_train_step
from repro.train.trainer import run_training as jax_run_training
from repro_torch.ckpt import latest_step
from repro_torch.configs.base import smoke_of
from repro_torch.interop import named_to_jax, params_from_jax, params_to_jax
from repro_torch.kernels import moe_gating, ref
from repro_torch.models import bundle_for
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW, constant
from repro_torch.train.step import make_train_step
from repro_torch.train.trainer import run_training
from test_torch_executors import resume_on_the_other_framework

CPU = torch.device("cpu")
ARCH = "qwen3-moe-30b-a3b"
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _close(t_out, j_out, tol):
    np.testing.assert_allclose(np.asarray(t_out, np.float32), np.asarray(j_out, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# the router's backward
# ---------------------------------------------------------------------------

def _router_case(T_, E, k, seed, dup):
    """x (T,D) f32, the router (D,E) at the model's scale, the cotangents gw
    (T,k) and gprobs (T,E); ``dup`` repeats router columns in groups of 4, so
    logits tie exactly and the top-k breaks ties by index."""
    rng = np.random.default_rng(seed)
    D = 64
    x = rng.standard_normal((T_, D)).astype(np.float32)
    router = (rng.standard_normal((D, E)) * D ** -0.5).astype(np.float32)
    if dup:
        router = np.repeat(router[:, :-(-E // 4)], 4, axis=1)[:, :E].copy()
    gw = rng.standard_normal((T_, k)).astype(np.float32)
    gprobs = rng.standard_normal((T_, E)).astype(np.float32)
    return x, router, gw, gprobs


def _jax_router_vjp(x, router, k, gw, gprobs):
    """jax.vjp of the reference's chain (``repro/models/moe.py:106-112``):
    the f32 logits, ``moe_gating_ref`` and the softmax; (dx f32, drouter)."""
    def chain(xf, r):
        logits = xf.astype(jnp.float32) @ r
        w, _ = jref.moe_gating_ref(logits, k)
        return w, jax.nn.softmax(logits, axis=-1)
    _, vjp = jax.vjp(chain, jnp.asarray(x), jnp.asarray(router))
    return vjp((jnp.asarray(gw), jnp.asarray(gprobs)))


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("E,k", [(8, 1), (8, 2), (60, 2), (60, 8), (128, 1), (128, 8)])
@pytest.mark.parametrize("T_", [1, 4, 9, 300])
def test_router_bwd_ref_matches_autograd_and_jax_vjp(T_, E, k, dup):
    """The closed form and its two products, from random gw with gprobs
    present and absent, x in f32 and bf16."""
    x, router, gw, gprobs = _router_case(T_, E, k, T_ * E + k, dup)
    for dtype in (torch.float32, torch.bfloat16):
        tx = torch.tensor(x).to(dtype)
        xf = tx.float().numpy()                       # x as the forward reads it
        for gp in (gprobs, None):
            leaves = [torch.tensor(xf, requires_grad=True),
                      torch.tensor(router, requires_grad=True)]
            w, ids, probs = ref.moe_router_ref(*leaves, k)
            outs, cots = [w], [torch.tensor(gw)]
            if gp is not None:
                outs.append(probs)
                cots.append(torch.tensor(gp))
            auto = torch.autograd.grad(outs, leaves, cots)
            dl = ref.moe_router_bwd_ref(torch.tensor(gw), None if gp is None else
                                        torch.tensor(gp), w.detach(), ids, probs.detach())
            closed = (dl @ torch.tensor(router).T, torch.tensor(xf).T @ dl)
            jgrads = _jax_router_vjp(xf, router, k, gw,
                                     np.zeros((T_, E), np.float32) if gp is None else gp)
            for got, want, jwant in zip(closed, auto, jgrads):
                _close(got, want, TOL["float32"])
                _close(got, jwant, TOL["float32"])
            if dtype == torch.bfloat16:   # the cast the op's backward applies
                _close(closed[0].to(dtype).float(), jgrads[0], TOL["bfloat16"])


def test_router_bwd_ref_is_the_logits_gradient():
    """In f64 the closed form is autograd's gradient of the logits to
    rounding, exact ties included."""
    rng = np.random.default_rng(3)
    logits = torch.tensor(np.round(rng.standard_normal((50, 16)), 1), dtype=torch.float64,
                          requires_grad=True)
    _, ids = ref.moe_gating_ref(logits.detach(), 4)
    probs = torch.softmax(logits, dim=-1)
    s = probs.gather(1, ids.long())
    w = s / s.sum(dim=1, keepdim=True)           # moe_gating_ref's weights, in f64
    gw, gp = (torch.tensor(rng.standard_normal(shape)) for shape in ((50, 4), (50, 16)))
    (auto,) = torch.autograd.grad([w, probs], [logits], [gw, gp])
    closed = ref.moe_router_bwd_ref(gw, gp, w.detach(), ids, probs.detach())
    torch.testing.assert_close(closed, auto, atol=1e-13, rtol=1e-13)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_gw,with_gprobs", [(True, True), (True, False), (False, True)])
def test_router_op_backward_on_the_cpu(monkeypatch, x_dtype, with_gw, with_gprobs):
    """The registered op's backward (``moe_gating._backward``) with the
    kernel replaced by its plain closed form: dx in x's dtype and drouter in
    f32, as autograd through the plain router gives them; an output that
    nothing reads arrives as None; no gradient where none is needed."""
    monkeypatch.setattr(moe_gating, "moe_router_bwd", ref.moe_router_bwd_ref)
    x, router, gw, gprobs = _router_case(40, 16, 4, 11, False)
    tx, tr = torch.tensor(x).to(x_dtype), torch.tensor(router)
    w, ids, probs = ref.moe_router_ref(tx, tr, 4)
    ctx = types.SimpleNamespace(saved_tensors=(tx, tr, w, ids, probs),
                                needs_input_grad=(True, True, False))
    g_w = torch.tensor(gw) if with_gw else None
    g_p = torch.tensor(gprobs) if with_gprobs else None
    dx, drouter, dk = moe_gating._backward(ctx, g_w, None, g_p)
    leaves = [tx.clone().requires_grad_(), tr.clone().requires_grad_()]
    aw, _, ap = ref.moe_router_ref(*leaves, 4)
    outs = [o for o, g in ((aw, g_w), (ap, g_p)) if g is not None]
    auto = torch.autograd.grad(outs, leaves, [g for g in (g_w, g_p) if g is not None])
    assert dk is None and dx.dtype == x_dtype and drouter.dtype == torch.float32
    _close(dx.float(), auto[0].float(), TOL["float32" if x_dtype == torch.float32
                                            else "bfloat16"])
    _close(drouter, auto[1], TOL["float32"])
    ctx.needs_input_grad = (False, True, False)
    assert moe_gating._backward(ctx, g_w, None, g_p)[0] is None
    assert moe_gating._backward(ctx, None, None, None) == (None, None, None)


# ---------------------------------------------------------------------------
# loss_fn and every gradient
# ---------------------------------------------------------------------------

def _pair(dtype="float32", **overrides):
    """(jax cfg, jax params, torch cfg, torch params) of qwen3-moe-smoke with
    equal weights."""
    jcfg = dataclasses.replace(jax_smoke(ARCH), dtype=dtype, **overrides)
    cfg = dataclasses.replace(smoke_of(ARCH), dtype=dtype, **overrides)
    jparams = jax_bundle(jcfg).init(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(_flatten(jparams), cfg, device=CPU)
    params.requires_grad_(True)
    return jcfg, jparams, cfg, params


def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _jax_value_and_grads(jcfg, jparams, batch, remat="none"):
    loss_fn = jax_bundle(jcfg).loss_fn
    jl, jg = jax.value_and_grad(lambda p: loss_fn(
        jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}, remat=remat))(jparams)
    return float(jl), _flatten(jg)


def _port_value_and_grads(cfg, params, batch, remat="none"):
    loss = bundle_for(cfg).loss_fn(cfg, params, {k: torch.tensor(v) for k, v in batch.items()},
                                   remat=remat)
    grads = torch.autograd.grad(loss, list(params.parameters()))
    return loss.item(), named_to_jax(zip((n for n, _ in params.named_parameters()), grads))


@pytest.mark.parametrize("dtype,remat,capacity_factor", [
    ("float32", "none", 1.25), ("float32", "full", 1.25), ("float32", "dots", 1.25),
    ("float32", "none", 0.25),        # capacity 8 of ~12 assignments an expert: drops
    ("float32", "dots", 0.25),
    ("bfloat16", "none", 1.25),
])
def test_loss_fn_and_every_gradient_match_jax(dtype, remat, capacity_factor):
    jcfg, jparams, cfg, params = _pair(dtype, capacity_factor=capacity_factor)
    batch = _batch(cfg, 2, 24)
    jl, jg = _jax_value_and_grads(jcfg, jparams, batch, remat)
    tl, tg = _port_value_and_grads(cfg, params, batch, remat)
    tol = TOL[dtype]
    assert abs(tl - jl) <= tol * (1 + abs(jl))
    assert set(tg) == set(jg) and "blocks/moe/router" in tg
    for key in jg:
        _close(tg[key], jg[key], tol)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_loss_is_lm_loss_plus_the_aux_term(capacity_factor):
    """loss - lm_loss = 0.01 x the mean per-layer aux, which matches the
    reference's; the aux is not zero and reaches every router."""
    jcfg, jparams, cfg, params = _pair(capacity_factor=capacity_factor)
    batch = _batch(cfg, 2, 24, seed=1)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    x, aux = M.hidden(cfg, params, tb["tokens"])
    lm = T.lm_loss(cfg, params, x, tb["labels"])
    loss = M.loss_fn(cfg, params, tb)
    assert M.AUX_LOSS_COEF == 0.01
    _close(loss.detach() - lm.detach(), 0.01 * aux.detach(), TOL["float32"])
    from repro.models import moe as JM
    _, jaux = JM.hidden(jcfg, jparams, jnp.asarray(batch["tokens"]))
    _close(aux.detach(), jaux, TOL["float32"])
    routers = [blk.moe.router for blk in params.blocks]
    for g in torch.autograd.grad(aux, routers):
        assert float(g.abs().max()) > 0


def test_apply_and_serving_run_without_autograd():
    _, _, cfg, params = _pair()
    tokens = torch.tensor(_batch(cfg, 1, 8)["tokens"])
    assert bundle_for(cfg).apply(cfg, params, tokens).grad_fn is None
    logits, _ = bundle_for(cfg).prefill(cfg, params, tokens)
    assert logits.grad_fn is None


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_step_matches_jax(microbatch):
    """One AdamW step, port against reference, from equal weights: loss,
    gradient norm, the first moments (0.1 x the clipped gradient g) at 2e-5,
    and the parameters.  A first step moves an element by lr g / (|g| +
    eps), a steep function of g where |g| is near eps, so each parameter is
    held to 2e-5 plus 2% of one step (lr), as the dense test holds them,
    plus what the gradient's own tolerance moves the step by there, lr eps
    2e-5 / (|g| + eps)^2 (an lm_head element with |g| = 2e-8 reads 6.6% of
    lr).  With microbatches each one sizes its own capacity and aux, so the
    step differs from the unsplit batch's: it is held to the reference's
    microbatched step."""
    jcfg, jparams, cfg, params = _pair()
    batch = _batch(cfg, 4, 16, seed=8)
    lr, eps, tol = 1e-3, 1e-8, TOL["float32"]
    jopt, opt = JAdamW(lr=jconstant(lr), eps=eps), AdamW(lr=constant(lr), eps=eps)
    jstate, jm = jax.jit(jax_make_train_step(jcfg, jopt, microbatch=microbatch))(
        {"params": jparams, "opt": jopt.init(jparams)},
        {k: jnp.asarray(v) for k, v in batch.items()})
    state, tm = make_train_step(cfg, opt, microbatch=microbatch)(
        {"params": params, "opt": opt.init(params)},
        {k: torch.tensor(v) for k, v in batch.items()})
    _close(tm["loss"], jm["loss"], tol)
    _close(tm["grad_norm"], jm["grad_norm"], tol)
    assert state["opt"].m["blocks.0.moe.router"].dtype == torch.float32
    assert state["params"].blocks[0].moe.router.dtype == torch.float32
    jmoments = _flatten(jstate["opt"].m)
    for key, want in named_to_jax(state["opt"].m.items()).items():
        _close(want, jmoments[key], tol)
    got = params_to_jax(state["params"])
    for key, want in _flatten(jstate["params"]).items():
        g = np.abs(np.asarray(jmoments[key])) / (1 - jopt.b1)
        bound = tol + 0.02 * lr + lr * eps * tol / (g + eps) ** 2 + tol * np.abs(want)
        assert (np.abs(got[key] - want) <= bound).all(), key


def test_bf16_step_keeps_the_router_and_moments_in_f32():
    _, _, cfg, params = _pair("bfloat16")
    opt = AdamW(lr=constant(1e-3))
    state, m = make_train_step(cfg, opt)({"params": params, "opt": opt.init(params)},
                                         {k: torch.tensor(v) for k, v in
                                          _batch(cfg, 2, 16).items()})
    assert np.isfinite(float(m["loss"]))
    for name, p in state["params"].named_parameters():
        want = torch.float32 if name.endswith("moe.router") else torch.bfloat16
        assert p.dtype == want, name
        assert state["opt"].m[name].dtype == state["opt"].v[name].dtype == torch.float32


# ---------------------------------------------------------------------------
# resumed runs and jobs across frameworks
# ---------------------------------------------------------------------------

def _copy_lake(lake):
    other = DataLake()
    for key in lake.store.keys():
        other.store.put(key, bytes(lake.store.get(key)))
    return other


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_run_resumes_across_frameworks(first):
    """qwen3-moe-smoke in f32: ``first`` trains 4 steps (checkpoints at 2
    and 4); from copies of its lake both frameworks resume to step 8 on the
    same batches, held to 1e-4 as the dense run is (four AdamW steps of f32
    noise).  The last checkpoint restores in the other framework."""
    jcfg = dataclasses.replace(jax_smoke(ARCH), dtype="float32")
    cfg = dataclasses.replace(smoke_of(ARCH), dtype="float32")
    kw = dict(batch=4, seq=32, run_name="m", ckpt_every=2, seed=1)
    lake = DataLake()
    head = (jax_run_training(jcfg, steps=4, lake=lake, **kw) if first == "jax" else
            run_training(cfg, steps=4, lake=lake, device="cpu", **kw))
    assert head.steps_done == 4
    jlake, tlake = _copy_lake(lake), _copy_lake(lake)
    want = jax_run_training(jcfg, steps=8, lake=jlake, **kw)
    got = run_training(cfg, steps=8, lake=tlake, device="cpu", **kw)
    assert want.resumed_from == got.resumed_from == 4
    assert got.steps_done == 8 and len(got.losses) == 4
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4, atol=1e-4)
    assert latest_step(tlake, "m") == 8
    template = jax.eval_shape(lambda k: jax_make_train_state(jcfg, k, JAdamW(lr=jconstant(0))),
                              jax.ShapeDtypeStruct((2,), jnp.uint32))
    jstate, step = jax_restore(tlake, "m", template)
    assert step == 8 and int(jstate["opt"].step) == 8
    assert "blocks/moe/router" in _flatten(jstate["params"])


@pytest.mark.parametrize("first,then", [("jax", "torch"), ("torch", "jax")])
def test_moe_train_job_resumes_on_the_other_framework(monkeypatch, first, then):
    """``qwen3-1.7b-smoke``, which both frameworks resolve to the MoE smoke:
    killed after its step-2 checkpoint on one framework's pod, resumed on
    the other's (``test_torch_executors.resume_on_the_other_framework``)."""
    result = resume_on_the_other_framework(monkeypatch, first, then, "qwen3-1.7b-smoke")
    assert result["arch"] == "qwen3-moe-smoke"
