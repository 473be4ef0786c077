"""PyTorch port, hybrid (zamba2) training on the CPU against the JAX package:
the SSD state scan's backward in closed form (``ref.ssd_state_scan_bwd_ref``)
against autograd through the plain scan and ``jax.vjp`` of the reference's
``ssd_state_scan_ref``; the registered op's backward; the hybrid
``loss_fn`` and every gradient under each remat policy, at one, several and
ragged chunks, in f32 and bf16; one AdamW step and a microbatched step; a
``run_training`` run resumed across frameworks; and a ``zamba2-smoke``
train job killed on one framework's pod and resumed on the other's.

Weights come from the JAX ``bundle.init`` through ``interop``, inputs from
numpy seeds.  Tolerances: 2e-5 in f32 (elementwise, atol = rtol).  In bf16
the two frameworks round at different places (``tests/test_torch_hybrid.py``)
and a few elements of a gradient differ by one bf16 step of their size, so
each bf16 gradient tensor's relative error against JAX's f32 gradient is
held to 1.5x JAX's own bf16 error, as the bf16 prefill is.
"""

import dataclasses
import functools
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
from repro_torch.kernels import ref, ssd_scan
from repro_torch.models import bundle_for
from repro_torch.models import hybrid as H
from repro_torch.models.model import TRAINED_FAMILIES
from repro_torch.optim import AdamW, constant
from repro_torch.train.step import make_prefill, make_train_step
from repro_torch.train.trainer import run_training
from test_torch_executors import resume_on_the_other_framework
from test_torch_moe_train import _copy_lake

CPU = torch.device("cpu")
ARCH = "zamba2-2.7b"
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
BF16_SLACK = 1.5     # the port's bf16 error at most this times JAX's own


def _close(t_out, j_out, tol):
    np.testing.assert_allclose(np.asarray(t_out, np.float32), np.asarray(j_out, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# the scan's backward
# ---------------------------------------------------------------------------

def _scan_case(B, C, Hh, P, N, seed):
    """chunk states, decays in [0.3, 0.99], an initial state and the
    cotangents of prefix and final, f32 numpy."""
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((B, C, Hh, P, N)).astype(np.float32)
    a = rng.uniform(0.3, 0.99, (B, C, Hh)).astype(np.float32)
    s0 = rng.standard_normal((B, Hh, P, N)).astype(np.float32)
    g_prefix = rng.standard_normal((B, C, Hh, P, N)).astype(np.float32)
    g_final = rng.standard_normal((B, Hh, P, N)).astype(np.float32)
    return xs, a, s0, g_prefix, g_final


COTANGENTS = [(True, True), (True, False), (False, True)]   # (g_prefix, g_final) present


def _autograd_scan(leaves, g_prefix, g_final):
    """Autograd's gradient of the plain scan's leaves from the cotangents
    (None: nothing reads that output); zeros where no path leads to a leaf
    (at C = 1 without an initial state the prefix is a constant zero)."""
    outs = ref.ssd_state_scan_ref(*leaves)
    dot = sum((o * g).sum() for o, g in zip(outs, (g_prefix, g_final)) if g is not None)
    grads = (torch.autograd.grad(dot, leaves, allow_unused=True) if dot.requires_grad
             else [None] * len(leaves))
    return [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]


@pytest.mark.parametrize("g_prefix_in,g_final_in", COTANGENTS)
@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("B,C,Hh,P,N", [
    (2, 4, 3, 8, 8), (1, 1, 2, 16, 4),      # C = 1
    (3, 5, 4, 5, 7),                        # P * N = 35, no power of two
    (1, 16, 2, 32, 64),
])
def test_ssd_scan_bwd_ref_matches_autograd_and_jax_vjp(B, C, Hh, P, N, with_init,
                                                       g_prefix_in, g_final_in):
    xs, a, s0, gp, gf = _scan_case(B, C, Hh, P, N, B * 100 + C * 10 + P)
    gp, gf = (gp if g_prefix_in else None), (gf if g_final_in else None)
    leaves = [torch.tensor(xs, requires_grad=True), torch.tensor(a, requires_grad=True)]
    if with_init:
        leaves.append(torch.tensor(s0, requires_grad=True))
    t_gp, t_gf = (None if g is None else torch.tensor(g) for g in (gp, gf))
    auto = _autograd_scan(leaves, t_gp, t_gf)
    prefix = ref.ssd_state_scan_ref(*leaves)[0].detach()
    closed = ref.ssd_state_scan_bwd_ref(t_gp, t_gf, prefix, leaves[1].detach(), with_init)
    assert (closed[2] is None) != with_init
    jleaves = [jnp.asarray(t.detach().numpy()) for t in leaves]
    _, vjp = jax.vjp(jref.ssd_state_scan_ref, *jleaves)
    jgrads = vjp((jnp.zeros_like(jnp.asarray(xs)) if gp is None else jnp.asarray(gp),
                  jnp.zeros_like(jnp.asarray(s0)) if gf is None else jnp.asarray(gf)))
    for got, want, jwant in zip(closed, auto, jgrads):
        _close(got, want, TOL["float32"])
        _close(got, jwant, TOL["float32"])


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("g_prefix_in,g_final_in", COTANGENTS)
def test_scan_op_backward_on_the_cpu(monkeypatch, with_init, g_prefix_in, g_final_in):
    """The registered op's backward (``ssd_scan._backward``) with the kernel
    replaced by its plain closed form, as autograd through the plain scan
    gives it; an output that nothing reads arrives as None; no gradient
    where none is needed, and none at all from no cotangent."""
    monkeypatch.setattr(ssd_scan, "ssd_state_scan_bwd", ref.ssd_state_scan_bwd_ref)
    xs, a, s0, gp, gf = (torch.tensor(t) for t in _scan_case(2, 3, 4, 8, 4, 5))
    s0 = s0 if with_init else None
    prefix, _ = ref.ssd_state_scan_ref(xs, a, s0)
    g_p, g_f = (gp if g_prefix_in else None), (gf if g_final_in else None)
    ctx = types.SimpleNamespace(saved_tensors=(prefix, a), has_init=with_init,
                                needs_input_grad=(True, True, with_init))
    got = ssd_scan._backward(ctx, g_p, g_f)
    auto = _autograd_scan([t.clone().requires_grad_() for t in (xs, a, s0) if t is not None],
                          g_p, g_f)
    assert (got[2] is None) != with_init
    for g, w in zip(got, auto):
        _close(g, w, TOL["float32"])
    ctx.needs_input_grad = (False, True, False)
    d_states, d_decays, d_init = ssd_scan._backward(ctx, g_p, g_f)
    assert d_states is None and d_init is None
    _close(d_decays, auto[1], TOL["float32"])
    assert ssd_scan._backward(ctx, None, None) == (None, None, None)


# ---------------------------------------------------------------------------
# loss_fn and every gradient
# ---------------------------------------------------------------------------

def _pair(dtype="float32", **overrides):
    """(jax cfg, jax params, torch cfg, torch params) of zamba2-smoke with
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


@functools.lru_cache(maxsize=None)
def _jax_value_and_grads(dtype, remat, S, chunk, seed):
    """JAX's loss and flattened gradients of zamba2-smoke on the batch
    (2, S) of ``seed``, once per case (the bf16 cases reuse the f32 ones)."""
    jcfg, jparams, _, _ = _pair(dtype, chunk=chunk)
    batch = _batch(jcfg, 2, S, seed)
    loss_fn = jax_bundle(jcfg).loss_fn
    jl, jg = jax.value_and_grad(lambda p: loss_fn(
        jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}, remat=remat))(jparams)
    return float(jl), {k: np.asarray(v, np.float32) for k, v in _flatten(jg).items()}


def _port_value_and_grads(dtype, remat, S, chunk, seed):
    _, _, cfg, params = _pair(dtype, chunk=chunk)
    batch = _batch(cfg, 2, S, seed)
    loss = bundle_for(cfg).loss_fn(cfg, params, {k: torch.tensor(v) for k, v in batch.items()},
                                   remat=remat)
    grads = torch.autograd.grad(loss, list(params.parameters()))
    return loss.item(), named_to_jax(zip((n for n, _ in params.named_parameters()), grads))


# (tokens, chunk): one chunk (the scan at C = 1), four chunks, three with
# the last one padded
LENGTHS = [(16, 16), (32, 8), (40, 16)]
REMATS = ["none", "full", "dots"]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("S,chunk", LENGTHS)
@pytest.mark.parametrize("remat", REMATS)
def test_loss_fn_and_every_gradient_match_jax(remat, S, chunk, seed):
    jl, jg = _jax_value_and_grads("float32", remat, S, chunk, seed)
    tl, tg = _port_value_and_grads("float32", remat, S, chunk, seed)
    assert abs(tl - jl) <= TOL["float32"] * (1 + abs(jl))
    assert set(tg) == set(jg) and "mamba/ssm/a_log" in tg
    for key in jg:
        _close(tg[key], jg[key], TOL["float32"])


@pytest.mark.parametrize("S,chunk", [LENGTHS[0], LENGTHS[2]])
@pytest.mark.parametrize("remat", REMATS)
def test_loss_fn_and_every_gradient_match_jax_bf16(remat, S, chunk):
    """Against JAX's f32 loss and gradients, the port's bf16 error at most
    BF16_SLACK times JAX's bf16 error: the loss's, and each gradient
    tensor's relative (Euclidean) error."""
    l32, g32 = _jax_value_and_grads("float32", remat, S, chunk, 0)
    jl, jg = _jax_value_and_grads("bfloat16", remat, S, chunk, 0)
    tl, tg = _port_value_and_grads("bfloat16", remat, S, chunk, 0)
    assert abs(tl - l32) <= BF16_SLACK * abs(jl - l32)
    assert set(tg) == set(g32)
    for key, want in g32.items():
        norm = np.linalg.norm(want)
        et, ej = (np.linalg.norm(np.asarray(g, np.float32) - want) / norm
                  for g in (tg[key], jg[key]))
        assert et <= BF16_SLACK * ej, (key, et, ej)


def test_every_family_trains_through_its_own_loss():
    assert "hybrid" in TRAINED_FAMILIES
    cfg = smoke_of(ARCH)
    assert bundle_for(cfg).loss_fn is H.loss_fn


def test_apply_and_serving_run_without_autograd():
    _, _, cfg, params = _pair()
    tokens = torch.tensor(_batch(cfg, 1, 20)["tokens"])
    assert bundle_for(cfg).apply(cfg, params, tokens).grad_fn is None
    logits, cache = make_prefill(cfg)(params, {"tokens": tokens}, max_seq=24)
    assert logits.grad_fn is None and cache["state"].grad_fn is None
    logits, _ = bundle_for(cfg).decode_step(cfg, params, cache, tokens[:, :1])
    assert logits.grad_fn is None


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_step_matches_jax(microbatch):
    """One AdamW step, port against reference, from equal weights: loss,
    gradient norm, the first moments (0.1 x the clipped gradient) at 2e-5,
    and the parameters, each held to 2e-5 plus 2% of one step (lr) plus what
    the gradient's own tolerance moves the step by where |g| is near eps, as
    the MoE test holds them (``tests/test_torch_moe_train.py``)."""
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
    jmoments = _flatten(jstate["opt"].m)
    for key, want in named_to_jax(state["opt"].m.items()).items():
        _close(want, jmoments[key], tol)
    got = params_to_jax(state["params"])
    for key, want in _flatten(jstate["params"]).items():
        g = np.abs(np.asarray(jmoments[key])) / (1 - jopt.b1)
        bound = tol + 0.02 * lr + lr * eps * tol / (g + eps) ** 2 + tol * np.abs(want)
        assert (np.abs(got[key] - want) <= bound).all(), key


# ---------------------------------------------------------------------------
# resumed runs and jobs across frameworks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("first", ["jax", "torch"])
def test_run_resumes_across_frameworks(first):
    """zamba2-smoke in f32: ``first`` trains 4 steps (checkpoints at 2 and
    4); from copies of its lake both frameworks resume to step 8 on the same
    batches, held to 1e-4 as the dense and MoE runs are (four AdamW steps of
    f32 noise).  The last checkpoint restores in the other framework."""
    jcfg = dataclasses.replace(jax_smoke(ARCH), dtype="float32")
    cfg = dataclasses.replace(smoke_of(ARCH), dtype="float32")
    kw = dict(batch=4, seq=32, run_name="z", ckpt_every=2, seed=1)
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
    assert latest_step(tlake, "z") == 8
    template = jax.eval_shape(lambda k: jax_make_train_state(jcfg, k, JAdamW(lr=jconstant(0))),
                              jax.ShapeDtypeStruct((2,), jnp.uint32))
    jstate, step = jax_restore(tlake, "z", template)
    assert step == 8 and int(jstate["opt"].step) == 8
    assert "mamba/ssm/a_log" in _flatten(jstate["params"])


@pytest.mark.parametrize("first,then", [("jax", "torch"), ("torch", "jax")])
def test_hybrid_train_job_resumes_on_the_other_framework(monkeypatch, first, then):
    """``zamba2-smoke``: killed after its step-2 checkpoint on one
    framework's pod, resumed on the other's
    (``test_torch_executors.resume_on_the_other_framework``)."""
    result = resume_on_the_other_framework(monkeypatch, first, then, "zamba2-smoke")
    assert result["arch"] == "zamba2-smoke"
