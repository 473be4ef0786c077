"""PyTorch port, the encoder-decoder family (seamless-smoke) on the CPU
against the JAX package: the encoder, the logits, prefill and decode steps
with their caches (``enc_len`` defaulting to ``max_seq``); ``loss_fn`` and
every gradient under each remat policy; frames of another dtype than the
model's, which both frameworks refuse; one AdamW step and a microbatched one; a ``run_training`` run resumed across
frameworks; the train executors on a seamless-smoke job.

Weights come from the JAX ``bundle.init`` through ``interop``, inputs from
numpy seeds.  Tolerances: 2e-5 in f32 (atol = rtol).  In bf16 the prefill
logits, each gradient tensor and the vector of the tokens' losses are held
to 1.5x JAX's own bf16 error against JAX's f32 result, as the hybrid's
are (``tests/test_torch_hybrid_train.py``), and so are three decode steps
from JAX's own bf16 cache.

Frames in another dtype than the model's (``SyntheticLM`` makes f32 frames)
would change the dtype of the reference's encoder or decoder ``lax.scan``
carry, and it raises; the port refuses them too, at each entry point.
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
from repro.models import bundle_for as jax_bundle
from repro.models import encdec as JE
from repro.models import transformer as JT
from repro.optim import AdamW as JAdamW
from repro.optim import constant as jconstant
from repro.runtime import executors as jex
from repro.train.step import make_prefill as jax_make_prefill
from repro.train.step import make_train_state as jax_make_train_state
from repro.train.step import make_train_step as jax_make_train_step
from repro.train.trainer import run_training as jax_run_training
from repro_torch.ckpt import latest_step
from repro_torch.configs.base import ShapeConfig, smoke_of
from repro_torch.interop import named_to_jax, params_from_jax, params_to_jax
from repro_torch.models import bundle_for, input_specs, synth_batch
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.models.model import PORTED_FAMILIES, TRAINED_FAMILIES
from repro_torch.optim import AdamW, constant
from repro_torch.runtime import executors as tex
from repro_torch.train.step import make_prefill, make_serve_step, make_train_step
from repro_torch.train.trainer import run_training
from test_torch_executors import _jobs
from test_torch_moe_train import _copy_lake

CPU = torch.device("cpu")
ARCH = "seamless-m4t-large-v2"
TOL = 2e-5
BF16_SLACK = 1.5     # the port's bf16 error at most this times JAX's own
REMATS = ["none", "full", "dots"]


def _close(t_out, j_out, tol=TOL):
    t = t_out.float().numpy() if isinstance(t_out, torch.Tensor) else t_out
    np.testing.assert_allclose(np.asarray(t, np.float32), np.asarray(j_out, np.float32),
                               atol=tol, rtol=tol)


@functools.lru_cache(maxsize=None)
def _pair(dtype="float32"):
    """(jax cfg, jax params, torch cfg, torch params) of seamless-smoke with
    equal weights, built once per dtype (tests must not modify them)."""
    jcfg = dataclasses.replace(jax_smoke(ARCH), dtype=dtype)
    cfg = dataclasses.replace(smoke_of(ARCH), dtype=dtype)
    jparams = jax_bundle(jcfg).init(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, cfg, params_from_jax(_flatten(jparams), cfg, device=CPU)


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _frames(cfg, B, F, seed=0):
    return np.random.default_rng(100 + seed).standard_normal((B, F, cfg.d_model)) \
        .astype(np.float32)


def _inputs(frames, tokens, dtype):
    """The same inputs for both frameworks; frames in ``dtype``."""
    jin = {"frames": jnp.asarray(frames, jnp.dtype(dtype)), "tokens": jnp.asarray(tokens)}
    tin = {"frames": torch.from_numpy(frames).to(getattr(torch, dtype)),
           "tokens": torch.tensor(tokens)}
    return jin, tin


# ---------------------------------------------------------------------------
# the model: encoder, logits, prefill, decode
# ---------------------------------------------------------------------------

def test_families_and_specs():
    """The bundle resolves; the input specs and the synthetic batch carry
    frames in the config's dtype, a one-token prompt and an ``enc_len`` of
    ``seq_len`` in the decode cache, as the reference's."""
    assert "encdec" in PORTED_FAMILIES and "encdec" in TRAINED_FAMILIES
    cfg = smoke_of(ARCH)
    assert bundle_for(cfg).family == "encdec" and bundle_for(cfg).loss_fn is E.loss_fn
    train = input_specs(cfg, ShapeConfig("s", "train", 8, 2))
    assert tuple(train["frames"].shape) == (2, 8, cfg.d_model)
    assert train["frames"].dtype == torch.bfloat16
    prefill = input_specs(cfg, ShapeConfig("s", "prefill", 8, 2))
    assert list(prefill) == ["frames", "tokens"] and tuple(prefill["tokens"].shape) == (2, 1)
    got = synth_batch(cfg, ShapeConfig("s", "decode", 8, 2), seed=1, device=CPU)
    assert int(got["cache"]["enc_len"]) == 8 and tuple(got["cache"]["xk"].shape)[2] == 8


def test_encode_matches_jax():
    jcfg, jparams, cfg, params = _pair()
    fr = _frames(cfg, 2, 11)
    _close(E.encode(cfg, params, torch.from_numpy(fr)), JE.encode(jcfg, jparams, fr))


def test_apply_matches_jax():
    jcfg, jparams, cfg, params = _pair()
    jin, tin = _inputs(_frames(cfg, 2, 9), _tokens(cfg, (2, 6)), "float32")
    _close(E.apply(cfg, params, tin), jax_bundle(jcfg).apply(jcfg, jparams, jin))


@pytest.mark.parametrize("F,S", [(9, 1), (16, 3)])
def test_prefill_and_decode_match_jax(F, S):
    """One BOS (S = 1) or a 3-token prompt over 9 or 16 frames: the last
    logits and every cache tensor after prefill, then three decode steps'
    logits and caches."""
    jcfg, jparams, cfg, params = _pair()
    jb = jax_bundle(jcfg)
    toks = _tokens(cfg, (2, S + 3), seed=F)
    jin, tin = _inputs(_frames(cfg, 2, F, seed=F), toks[:, :S], "float32")
    jlog, jcache = jax_make_prefill(jcfg)(jparams, jin, max_seq=S + 4)
    logits, cache = make_prefill(cfg)(params, tin, max_seq=S + 4)
    _close(logits, jlog)
    assert sorted(cache) == sorted(jcache)
    for name in jcache:
        assert tuple(cache[name].shape) == jcache[name].shape, name
        _close(cache[name], jcache[name])
    assert int(cache["enc_len"]) == F and int(cache["index"]) == S
    step = make_serve_step(cfg)
    for i in range(S, S + 3):
        jlog, jcache = jb.decode_step(jcfg, jparams, jcache, jnp.asarray(toks[:, i:i + 1]))
        logits, cache = step(params, cache, torch.from_numpy(toks[:, i:i + 1]))
        _close(logits, jlog)
    for name in ("k", "v"):
        _close(cache[name], jcache[name])
    assert int(cache["index"]) == S + 3


def test_init_cache_defaults_enc_len_to_max_seq():
    jcfg, _, cfg, _ = _pair("bfloat16")
    for kw in ({}, {"enc_len": 5}):
        jcache = jax_bundle(jcfg).init_cache(jcfg, 2, 12, **kw)
        cache = E.init_cache(cfg, 2, 12, device=CPU, **kw)
        assert sorted(cache) == sorted(jcache)
        for name, want in jcache.items():
            assert tuple(cache[name].shape) == want.shape, name
            assert cache[name].dtype == getattr(torch, str(want.dtype)), name
        assert int(cache["enc_len"]) == int(jcache["enc_len"]) == kw.get("enc_len", 12)


def test_decode_matches_teacher_forcing():
    """Greedy decode logits == the full forward's at the same positions."""
    _, _, cfg, params = _pair()
    toks = torch.from_numpy(_tokens(cfg, (1, 8), seed=5))
    fr = torch.from_numpy(_frames(cfg, 1, 10, seed=5))
    full = E.apply(cfg, params, {"frames": fr, "tokens": toks})
    _, cache = E.prefill(cfg, params, {"frames": fr, "tokens": toks[:, :1]}, max_seq=8)
    for i in range(1, 8):
        logits, cache = E.decode_step(cfg, params, cache, toks[:, i:i + 1])
        torch.testing.assert_close(logits[:, 0], full[:, i], atol=1e-4, rtol=1e-4)


def test_prefill_matches_jax_bf16():
    """bf16 prefill logits (bf16 frames) err against JAX's f32 logits at
    most 1.5x as much as JAX's bf16 prefill does (max and mean)."""
    jcfg32, jparams32, _, _ = _pair()
    jcfg, jparams, cfg, params = _pair("bfloat16")
    fr, toks = _frames(cfg, 2, 12, seed=4), _tokens(cfg, (2, 1), seed=4)
    want = np.asarray(jax_bundle(jcfg32).prefill(jcfg32, jparams32, _inputs(
        fr, toks, "float32")[0])[0])
    jin, tin = _inputs(fr, toks, "bfloat16")
    jerr = np.abs(np.asarray(jax_bundle(jcfg).prefill(jcfg, jparams, jin)[0], np.float32) - want)
    logits, cache = E.prefill(cfg, params, tin)
    assert logits.dtype == torch.bfloat16 and cache["xk"].dtype == torch.bfloat16
    err = np.abs(logits.float().numpy() - want)
    assert err.max() <= BF16_SLACK * jerr.max() and err.mean() <= BF16_SLACK * jerr.mean(), \
        (err.max(), jerr.max(), err.mean(), jerr.mean())


def test_decode_matches_jax_bf16():
    """bf16 ``decode_step`` from JAX's bf16 prefill cache (self-attention
    against the index, cross-attention against the 0-dim ``enc_len``),
    three steps, each on its own cache: the logits' error against JAX's f32
    decode from the same cache at most 1.5x JAX's bf16 error (max and
    mean).  The MLP's ``F.silu`` rounds once where the reference's rounds
    four times (``layers.silu``), so a logit near 0 can sit one bf16 step
    off JAX's; the error against f32 is what the bound holds."""
    jcfg32, jparams32, _, _ = _pair()
    jcfg, jparams, cfg, params = _pair("bfloat16")
    toks = _tokens(cfg, (2, 4), seed=6)
    jin, _ = _inputs(_frames(cfg, 2, 10, seed=6), toks[:, :1], "bfloat16")
    _, jcache = jax_bundle(jcfg).prefill(jcfg, jparams, jin, max_seq=6)
    cache = {k: (torch.tensor(np.asarray(v.astype(jnp.float32))).to(torch.bfloat16)
                 if v.dtype == jnp.bfloat16 else torch.from_numpy(np.array(v)))
             for k, v in jcache.items()}
    assert cache["enc_len"].dim() == 0
    jcache32 = {k: (v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v)
                for k, v in jcache.items()}
    for i in range(1, 4):
        tok = toks[:, i:i + 1]
        want, jcache32 = jax_bundle(jcfg32).decode_step(jcfg32, jparams32, jcache32,
                                                        jnp.asarray(tok))
        jlog, jcache = jax_bundle(jcfg).decode_step(jcfg, jparams, jcache, jnp.asarray(tok))
        logits, cache = E.decode_step(cfg, params, cache, torch.from_numpy(tok))
        assert logits.dtype == torch.bfloat16
        want = np.asarray(want)
        err = np.abs(logits.float().numpy() - want)
        jerr = np.abs(np.asarray(jlog, np.float32) - want)
        assert err.max() <= BF16_SLACK * jerr.max() and \
            err.mean() <= BF16_SLACK * jerr.mean(), (i, err.max(), jerr.max())


def test_weights_cross_both_ways():
    jcfg, jparams, cfg, params = _pair("bfloat16")
    arrays = _flatten(jparams)
    assert arrays["enc_blocks/attn/wq"].shape[0] == cfg.enc_layers
    assert arrays["dec_blocks/xattn/wk"].shape[0] == cfg.dec_layers
    back = params_to_jax(params)
    assert sorted(back) == sorted(arrays)
    for key, arr in arrays.items():
        np.testing.assert_array_equal(back[key], np.asarray(arr, np.float32), err_msg=key)


def test_init_is_seeded_and_shaped():
    cfg = smoke_of(ARCH)
    a, b = E.init(cfg, 3, device=CPU), E.init(cfg, 3, device=CPU)
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert len(a.enc_blocks) == cfg.enc_layers and len(a.dec_blocks) == cfg.dec_layers
    assert isinstance(a.enc_blocks[0], T.Block)
    assert bool((a.dec_blocks[1].norm3.w == 1).all())
    std = float(a.dec_blocks[0].xattn.wk.float().std())
    assert abs(std - cfg.d_model ** -0.5) < 0.2 * cfg.d_model ** -0.5


# ---------------------------------------------------------------------------
# loss_fn and every gradient
# ---------------------------------------------------------------------------

def _batch(cfg, B, S, seed, frames="model"):
    """Tokens, labels and frames (``frames``: "model" for the config's
    dtype, "float32" for f32, as ``SyntheticLM`` makes them)."""
    toks = _tokens(cfg, (B, S + 1), seed)
    fr = _frames(cfg, B, S, seed)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "frames": fr,
            "frames_dtype": cfg.dtype if frames == "model" else frames}


def _jax_batch(batch):
    return {"tokens": jnp.asarray(batch["tokens"]), "labels": jnp.asarray(batch["labels"]),
            "frames": jnp.asarray(batch["frames"], jnp.dtype(batch["frames_dtype"]))}


def _torch_batch(batch):
    return {"tokens": torch.tensor(batch["tokens"]), "labels": torch.tensor(batch["labels"]),
            "frames": torch.from_numpy(batch["frames"]).to(getattr(torch,
                                                                    batch["frames_dtype"]))}


@functools.lru_cache(maxsize=None)
def _jax_value_and_grads(dtype, remat, S, seed):
    jcfg, jparams, cfg, _ = _pair(dtype)
    batch = _jax_batch(_batch(cfg, 2, S, seed))
    fn = functools.partial(jax_bundle(jcfg).loss_fn, jcfg, batch=batch, remat=remat)
    jl, jg = jax.value_and_grad(lambda p: fn(p))(jparams)
    return float(jl), {k: np.asarray(v, np.float32) for k, v in _flatten(jg).items()}


def _port_value_and_grads(dtype, remat, S, seed):
    _, _, cfg, params = _pair(dtype)
    batch = _torch_batch(_batch(cfg, 2, S, seed))
    leaves = list(params.parameters())
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = E.loss_fn(cfg, params, batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.item(), named_to_jax(zip((n for n, _ in params.named_parameters()), grads))


@pytest.mark.parametrize("S", [8, 13])
@pytest.mark.parametrize("remat", REMATS)
def test_loss_fn_and_every_gradient_match_jax(remat, S):
    jl, jg = _jax_value_and_grads("float32", remat, S, 0)
    tl, tg = _port_value_and_grads("float32", remat, S, 0)
    assert abs(tl - jl) <= TOL * (1 + abs(jl))
    assert set(tg) == set(jg) and "dec_blocks/xattn/wk" in tg
    for key in jg:
        _close(tg[key], jg[key])


def _rel_errs(got, want, ref):
    """Each gradient tensor's relative (Euclidean) error against ``ref``,
    the port's and JAX's."""
    for key, r in ref.items():
        norm = np.linalg.norm(r)
        yield key, (np.linalg.norm(got[key] - r) / norm, np.linalg.norm(want[key] - r) / norm)


@functools.lru_cache(maxsize=None)
def _token_losses(dtype, S, seed):
    """Each token's next-token loss (f32), JAX's and the port's."""
    jcfg, jparams, cfg, params = _pair(dtype)
    batch = _batch(cfg, 2, S, seed)
    x = JE.hidden(jcfg, jparams, _jax_batch(batch))
    jlog = np.asarray(JT.logits_of(jcfg, jparams, x), np.float32)
    jtok = (np.log(np.exp(jlog - jlog.max(-1, keepdims=True)).sum(-1)) + jlog.max(-1)
            - np.take_along_axis(jlog, batch["labels"][..., None], -1)[..., 0])
    with torch.no_grad():
        logits = T.logits_of(cfg, params, E.hidden(cfg, params, _torch_batch(batch)))
        ttok = torch.nn.functional.cross_entropy(
            logits.float().flatten(0, 1), torch.tensor(batch["labels"]).long().flatten(),
            reduction="none")
    return jtok.reshape(-1), ttok.numpy()


@pytest.mark.parametrize("remat", REMATS)
def test_loss_fn_and_every_gradient_match_jax_bf16(remat):
    """A bf16 model with bf16 frames, against JAX's f32 model: each gradient
    tensor's relative error and that of the vector of the tokens' losses at
    most 1.5x JAX's own; the mean loss, a sum of signed errors, within the
    bf16 tolerance 3e-2."""
    S = 8
    l32, g32 = _jax_value_and_grads("float32", remat, S, 0)
    _, jg = _jax_value_and_grads("bfloat16", remat, S, 0)
    tl, tg = _port_value_and_grads("bfloat16", remat, S, 0)
    assert abs(tl - l32) <= 3e-2
    assert set(tg) == set(g32)
    for key, (et, ej) in _rel_errs(tg, jg, g32):
        assert et <= BF16_SLACK * ej, (key, et, ej)
    want, _ = _token_losses("float32", S, 0)
    jtok, ttok = _token_losses("bfloat16", S, 0)
    et, ej = (np.linalg.norm(t - want) / np.linalg.norm(want) for t in (ttok, jtok))
    assert et <= BF16_SLACK * ej, (et, ej)


@pytest.mark.parametrize("entry", ["loss_fn", "apply", "prefill"])
@pytest.mark.parametrize("model, frames", [("bfloat16", "float32"), ("float32", "bfloat16")])
def test_frames_of_another_dtype_are_refused_as_the_reference_refuses(model, frames, entry):
    """f32 frames in a bf16 model (what ``SyntheticLM`` feeds a training run)
    and bf16 frames in an f32 model: the reference raises ``TypeError`` at
    each entry point (its scan carry would change dtype), and so does the
    port, before it computes anything."""
    jcfg, jparams, cfg, params = _pair(model)
    batch = _batch(cfg, 2, 6, 3, frames=frames)
    jb, tb = _jax_batch(batch), _torch_batch(batch)
    prompt = {"frames": tb["frames"], "tokens": tb["tokens"][:, :1]}
    jcalls = {"loss_fn": lambda: jax_bundle(jcfg).loss_fn(jcfg, jparams, jb),
              "apply": lambda: jax_bundle(jcfg).apply(jcfg, jparams, jb),
              "prefill": lambda: jax_make_prefill(jcfg)(
                  jparams, {"frames": jb["frames"], "tokens": jb["tokens"][:, :1]}, max_seq=6)}
    calls = {"loss_fn": lambda: E.loss_fn(cfg, params, tb),
             "apply": lambda: E.apply(cfg, params, tb),
             "prefill": lambda: make_prefill(cfg)(params, prompt, max_seq=6)}
    with pytest.raises(TypeError, match="carry"):
        jcalls[entry]()
    with pytest.raises(TypeError, match="frames of torch.* in an encoder-decoder of torch"):
        calls[entry]()


# ---------------------------------------------------------------------------
# the train step, a resumed run, the executors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_step_matches_jax(microbatch):
    """One AdamW step from equal weights in f32: loss, gradient norm, the
    first moments at 2e-5, the parameters at 2e-5 plus 2% of one step, as
    the hybrid's (``tests/test_torch_hybrid_train.py``)."""
    jcfg = dataclasses.replace(jax_smoke(ARCH), dtype="float32")
    cfg = dataclasses.replace(smoke_of(ARCH), dtype="float32")
    jparams = jax_bundle(jcfg).init(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(_flatten(jparams), cfg, device=CPU).requires_grad_(True)
    batch = _batch(cfg, 4, 8, seed=8)
    lr, eps = 1e-3, 1e-8
    jopt, opt = JAdamW(lr=jconstant(lr), eps=eps), AdamW(lr=constant(lr), eps=eps)
    jstate, jm = jax.jit(jax_make_train_step(jcfg, jopt, microbatch=microbatch))(
        {"params": jparams, "opt": jopt.init(jparams)}, _jax_batch(batch))
    state, tm = make_train_step(cfg, opt, microbatch=microbatch)(
        {"params": params, "opt": opt.init(params)}, _torch_batch(batch))
    _close(tm["loss"], jm["loss"])
    _close(tm["grad_norm"], jm["grad_norm"])
    jmoments = _flatten(jstate["opt"].m)
    for key, want in named_to_jax(state["opt"].m.items()).items():
        _close(want, jmoments[key])
    got = params_to_jax(state["params"])
    for key, want in _flatten(jstate["params"]).items():
        g = np.abs(np.asarray(jmoments[key])) / (1 - jopt.b1)
        bound = TOL + 0.02 * lr + lr * eps * TOL / (g + eps) ** 2 + TOL * np.abs(want)
        assert (np.abs(got[key] - want) <= bound).all(), key


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_run_resumes_across_frameworks(first):
    """seamless-smoke in f32 (``SyntheticLM``'s f32 frames in an f32 model,
    which the reference trains): ``first`` trains 4 steps (checkpoints at 2
    and 4); from copies of its lake both frameworks resume to step 8 on the
    same batches, held to 1e-4 as the other families' runs are."""
    jcfg = dataclasses.replace(jax_smoke(ARCH), dtype="float32")
    cfg = dataclasses.replace(smoke_of(ARCH), dtype="float32")
    kw = dict(batch=2, seq=8, run_name="e", ckpt_every=2, seed=1)
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
    assert latest_step(tlake, "e") == 8
    template = jax.eval_shape(lambda k: jax_make_train_state(jcfg, k, JAdamW(lr=jconstant(0))),
                              jax.ShapeDtypeStruct((2,), jnp.uint32))
    jstate, step = jax_restore(tlake, "e", template)
    assert step == 8 and "dec_blocks/xattn/wq" in _flatten(jstate["params"])


def test_seamless_smoke_train_job_is_refused_on_both_frameworks():
    """A seamless-smoke train job (bf16, ``SyntheticLM``'s f32 frames): the
    reference's train executor raises in its first phase (the decoder scan's
    carry), and the port's refuses the frames in its first phase too, so the
    job fails wherever it is placed.  Which is why
    ``resume_on_the_other_framework`` has no seamless case."""
    fields = {"arch": "seamless-smoke", "shape": "custom", "chips": 1, "steps": 4}
    jjob, job = _jobs("train", fields)
    plan = jex.make_train_executor(ckpt_every=2)(jjob, types.SimpleNamespace(lake=DataLake()))
    with pytest.raises(TypeError, match="carry"):
        plan.phases[0][1]()
    plan = tex.make_train_executor(ckpt_every=2, device="cpu")(job, types.SimpleNamespace(
        lake=DataLake()))
    with pytest.raises(TypeError, match="frames of torch.float32 in an encoder-decoder"):
        plan.phases[0][1]()
