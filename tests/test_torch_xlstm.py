"""PyTorch port, the xLSTM family (xlstm-smoke) on the CPU against the JAX
package: the mLSTM's parallel, chunkwise and recurrent forms and the sLSTM's
loop and step, function by function; the sLSTM's first-step tie; the
model's logits, prefill (chunk-aligned, unaligned and at most
``conv_kernel`` tokens, the last two stepped token by token) and decode
steps with their cells; ``loss_fn`` and every gradient under each remat
policy at one chunk, several and a length off the chunk; one AdamW step and
a microbatched one; a ``run_training`` run resumed across frameworks.

Weights come from the JAX ``bundle.init`` through ``interop``, inputs from
numpy seeds.  Tolerances: 2e-5 in f32 (atol = rtol).  In bf16 the two
frameworks round at different places, so the bf16 prefill and each bf16
gradient tensor are held to 1.5x JAX's own bf16 error against JAX's f32
result, as the hybrid's are (``tests/test_torch_hybrid_train.py``); a
decode step from JAX's own cache at 3e-2.
"""

import dataclasses
import functools

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
from repro.models import xlstm as JX
from repro.optim import AdamW as JAdamW
from repro.optim import constant as jconstant
from repro.train.step import make_prefill as jax_make_prefill
from repro.train.step import make_train_state as jax_make_train_state
from repro.train.step import make_train_step as jax_make_train_step
from repro.train.trainer import run_training as jax_run_training
from repro_torch.ckpt import latest_step
from repro_torch.configs.base import smoke_of
from repro_torch.interop import named_to_jax, params_from_jax, params_to_jax
from repro_torch.models import bundle_for
from repro_torch.models import xlstm as X
from repro_torch.models.model import PORTED_FAMILIES, TRAINED_FAMILIES
from repro_torch.optim import AdamW, constant
from repro_torch.train.step import make_prefill, make_serve_step, make_train_step
from repro_torch.train.trainer import run_training
from test_torch_moe_train import _copy_lake

CPU = torch.device("cpu")
ARCH = "xlstm-350m"
TOL = 2e-5
BF16_SLACK = 1.5     # the port's bf16 error at most this times JAX's own
REMATS = ["none", "full", "dots"]
F32_GATES = ("mlstm.w_if", "mlstm.b_gates", "slstm.w_gates", "slstm.r_gates",
             "slstm.b_gates")


def _close(t_out, j_out, tol=TOL):
    t = t_out.float().numpy() if isinstance(t_out, torch.Tensor) else t_out
    np.testing.assert_allclose(np.asarray(t, np.float32), np.asarray(j_out, np.float32),
                               atol=tol, rtol=tol)


@functools.lru_cache(maxsize=None)
def _pair(dtype="float32"):
    """(jax cfg, jax params, torch cfg, torch params) of xlstm-smoke with
    equal weights, built once per dtype (tests must not modify them)."""
    jcfg = dataclasses.replace(jax_smoke(ARCH), dtype=dtype)
    cfg = dataclasses.replace(smoke_of(ARCH), dtype=dtype)
    jparams = jax_bundle(jcfg).init(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, cfg, params_from_jax(_flatten(jparams), cfg, device=CPU)


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _block_input(cfg, B, S, seed, dtype=np.float32):
    x = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)) * 0.5
    return x.astype(dtype)


def _mblock(dtype="float32"):
    """The first mLSTM block's parameters in both frameworks."""
    _, jparams, _, params = _pair(dtype)
    jp = jax.tree.map(lambda t: t[0, 0], jparams["mlstm"])["mlstm"]
    return jp, params.mlstm[0][0].mlstm


def _sblock(dtype="float32"):
    _, jparams, _, params = _pair(dtype)
    jp = jax.tree.map(lambda t: t[1], jparams["slstm"])["slstm"]
    return jp, params.slstm[1].slstm


# ---------------------------------------------------------------------------
# the cells, function by function
# ---------------------------------------------------------------------------

def test_families_and_dims():
    assert "ssm" in PORTED_FAMILIES and "ssm" in TRAINED_FAMILIES
    cfg = smoke_of(ARCH)
    assert bundle_for(cfg).family == "ssm" and bundle_for(cfg).loss_fn is X.loss_fn
    assert X.dims(cfg) == JX.dims(jax_smoke(ARCH)) and X.n_groups(cfg) == 2
    with pytest.raises(ValueError, match="slstm_every"):
        X.n_groups(dataclasses.replace(cfg, n_layers=5))


@pytest.mark.parametrize("S", [8, 12, 24, 3])
def test_mlstm_parallel_matches_jax(S):
    jcfg, _, cfg, _ = _pair()
    jp, p = _mblock()
    x = _block_input(cfg, 2, S, S)
    _close(X.mlstm_parallel(cfg, p, torch.from_numpy(x)), JX.mlstm_parallel(jcfg, jp, x))


@pytest.mark.parametrize("S", [8, 24, 32, 12])
def test_mlstm_chunkwise_matches_jax(S):
    """One chunk, three, four, and S % chunk != 0 (the parallel form); the
    final cell where the length allows it."""
    jcfg, _, cfg, _ = _pair()
    jp, p = _mblock()
    x = _block_input(cfg, 2, S, 10 + S)
    _close(X.mlstm_chunkwise(cfg, p, torch.from_numpy(x)), JX.mlstm_chunkwise(jcfg, jp, x))
    if S % cfg.chunk:
        with pytest.raises(ValueError, match="multiple of the chunk"):
            X.mlstm_chunkwise(cfg, p, torch.from_numpy(x), return_state=True)
        return
    out, cell = X.mlstm_chunkwise(cfg, p, torch.from_numpy(x), return_state=True)
    jout, jcell = JX.mlstm_chunkwise(jcfg, jp, x, return_state=True)
    _close(out, jout)
    for k in ("C", "n", "m", "conv"):
        _close(cell[k], jcell[k])


def test_mlstm_step_matches_jax_and_the_parallel_form():
    """Twelve recurrent steps against JAX's, output and cell at each step,
    then against the parallel form at ``tests/test_models.py``'s
    tolerance."""
    jcfg, _, cfg, _ = _pair()
    jp, p = _mblock()
    d_inner, H, hd = X.dims(cfg)
    x = _block_input(cfg, 2, 12, 3)
    jcell = {"C": jnp.zeros((2, H, hd, hd)), "n": jnp.zeros((2, H, hd)),
             "m": jnp.full((2, H), -1e30), "conv": jnp.zeros((2, cfg.conv_kernel - 1, d_inner))}
    cell = {k: torch.tensor(np.asarray(v)) for k, v in jcell.items()}
    outs = []
    for t in range(12):
        jo, jcell = JX.mlstm_step(jcfg, jp, x[:, t:t + 1], jcell)
        o, cell = X.mlstm_step(cfg, p, torch.from_numpy(x[:, t:t + 1]), cell)
        _close(o, jo)
        for k in jcell:
            _close(cell[k], jcell[k])
        outs.append(o)
    par = X.mlstm_parallel(cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), par.numpy(), atol=3e-4, rtol=3e-3)


def test_mlstm_gate_product_precisions_in_bf16():
    """The parallel forms multiply by ``w_if`` rounded to bf16 and return
    f32; the step multiplies by the f32 ``w_if``: each as JAX does it."""
    jcfg, _, cfg, _ = _pair("bfloat16")
    jp, p = _mblock("bfloat16")
    assert p.w_if.dtype == torch.float32 and p.w_up.dtype == torch.bfloat16
    x = _block_input(cfg, 2, 5, 4)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(x, jnp.bfloat16)
    *_, i_pre, f_pre, _, xm = X._mlstm_qkvif(cfg, p, xt)
    *_, ji, jf, _ = JX._mlstm_qkvif(jcfg, jp, xj)
    assert i_pre.dtype == torch.float32
    _close(i_pre, ji)
    _close(f_pre, jf)
    wide = xm.float() @ p.w_if + p.b_gates
    assert float((wide[..., :cfg.n_heads] - i_pre).abs().max()) > 1e-4   # not the same product


@pytest.mark.parametrize("S", [1, 3, 9])
def test_slstm_forward_matches_jax(S):
    jcfg, _, cfg, _ = _pair()
    jp, p = _sblock()
    x = _block_input(cfg, 2, S, 20 + S)
    _close(X.slstm_forward(cfg, p, torch.from_numpy(x)), JX.slstm_forward(jcfg, jp, x))
    if S > cfg.conv_kernel:
        out, cell = X.slstm_forward(cfg, p, torch.from_numpy(x), return_state=True)
        jout, jcell = JX.slstm_forward(jcfg, jp, x, return_state=True)
        for k in ("h", "c", "n", "m", "conv"):
            _close(cell[k], jcell[k])


def test_slstm_step_matches_jax():
    jcfg, _, cfg, _ = _pair()
    jp, p = _sblock()
    D = cfg.d_model
    x = _block_input(cfg, 2, 6, 31)
    jcell = {k: jnp.zeros((2, D)) for k in ("h", "c", "n")}
    jcell["m"] = jnp.full((2, D), -1e30)
    jcell["conv"] = jnp.zeros((2, cfg.conv_kernel - 1, D))
    cell = {k: torch.tensor(np.asarray(v)) for k, v in jcell.items()}
    for t in range(6):
        jo, jcell = JX.slstm_step(jcfg, jp, x[:, t:t + 1], jcell)
        o, cell = X.slstm_step(cfg, p, torch.from_numpy(x[:, t:t + 1]), cell)
        _close(o, jo)
        for k in jcell:
            _close(cell[k], jcell[k])


def test_slstm_first_step_ties_and_splits_the_gradient():
    """At t = 0 the normaliser is exactly 1 (m = i, i_s = 1, f_s = 0), so
    ``max(n, 1)`` ties: JAX's ``lax.max`` sends each side half the
    gradient, and so does ``torch.maximum``; ``clamp_min`` would send n
    all of it.  The gradients of one step held to ``jax.grad``'s."""
    jcfg, _, cfg, _ = _pair()
    jp, p = _sblock()
    x = _block_input(cfg, 2, 1, 41)
    xt = torch.from_numpy(x).requires_grad_()
    xg = X._causal_conv(xt.detach(), p.conv_w).float() @ p.w_gates + p.b_gates
    H = cfg.n_heads
    state = {k: torch.zeros((H, 2, cfg.d_model // H)) for k in ("h", "c", "n")}
    state["m"] = torch.full((H, 2, cfg.d_model // H), -1e30)
    _, st = X._slstm_cell(X._recurrent_weights(p), X._head_major(xg[:, 0], H, 4), state,
                          torch.ones(()))
    assert bool((st["n"] == 1.0).all())
    w = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 1, cfg.d_model))
                         .astype(np.float32))
    grad = torch.autograd.grad((X.slstm_forward(cfg, p, xt) * w).sum(), xt)[0]
    jgrad = jax.grad(lambda a: (JX.slstm_forward(jcfg, jp, a) * w.numpy()).sum())(x)
    _close(grad, jgrad)
    # the same step with the whole gradient sent through n differs
    n = torch.ones(3, requires_grad=True)
    half = torch.autograd.grad(torch.maximum(n, torch.ones(())).sum(), n)[0]
    whole = torch.autograd.grad(n.clamp_min(1.0).sum(), n)[0]
    assert torch.equal(half, torch.full((3,), 0.5)) and torch.equal(whole, torch.ones(3))


# ---------------------------------------------------------------------------
# the model: logits, prefill, decode
# ---------------------------------------------------------------------------

def test_apply_matches_jax():
    jcfg, jparams, cfg, params = _pair()
    for S in (6, 24):
        toks = _tokens(cfg, (2, S), seed=S)
        _close(X.apply(cfg, params, torch.from_numpy(toks)),
               jax_bundle(jcfg).apply(jcfg, jparams, jnp.asarray(toks)))


@pytest.mark.parametrize("S", [16, 13, 4, 3])
def test_prefill_and_decode_match_jax(S):
    """Chunk-aligned (the chunkwise form), unaligned and S <= conv_kernel
    (both stepped token by token): the last logits and every cell after
    prefill, then three decode steps' logits and cells."""
    jcfg, jparams, cfg, params = _pair()
    jb = jax_bundle(jcfg)
    toks = _tokens(cfg, (2, S + 3), seed=S)
    jlog, jcache = jax_make_prefill(jcfg)(jparams, {"tokens": jnp.asarray(toks[:, :S])},
                                          max_seq=S + 3)
    logits, cache = make_prefill(cfg)(params, {"tokens": torch.from_numpy(toks[:, :S])},
                                      max_seq=S + 3)
    _close(logits, jlog)
    assert sorted(cache) == sorted(jcache)
    for name in jcache:
        assert tuple(cache[name].shape) == jcache[name].shape, name
        assert cache[name].dtype == getattr(torch, str(jcache[name].dtype)), name
        _close(cache[name], jcache[name])
    step = make_serve_step(cfg)
    for i in range(S, S + 3):
        jlog, jcache = jb.decode_step(jcfg, jparams, jcache, jnp.asarray(toks[:, i:i + 1]))
        logits, cache = step(params, cache, torch.from_numpy(toks[:, i:i + 1]))
        _close(logits, jlog)
    for name in jcache:
        _close(cache[name], jcache[name])
    assert int(cache["index"]) == S + 3


def test_decode_matches_prefill_continuation():
    """prefill(16) then eight decode steps == prefill(24)'s last logits."""
    _, _, cfg, params = _pair()
    t = torch.from_numpy(_tokens(cfg, (1, 24), seed=8))
    full, _ = X.prefill(cfg, params, t)
    _, cache = X.prefill(cfg, params, t[:, :16])
    for i in range(16, 24):
        logits, cache = X.decode_step(cfg, params, cache, t[:, i:i + 1])
    torch.testing.assert_close(logits, full, atol=1e-4, rtol=1e-4)


def test_prefill_matches_jax_bf16():
    """bf16 prefill logits err against JAX's f32 logits at most 1.5x as much
    as JAX's bf16 prefill does (max and mean), chunk-aligned and not."""
    jcfg32, jparams32, _, _ = _pair()
    jcfg, jparams, cfg, params = _pair("bfloat16")
    for name in F32_GATES:
        group, leaf = name.split(".")
        blk = params.mlstm[0][0] if group == "mlstm" else params.slstm[0]
        assert getattr(getattr(blk, group), leaf).dtype == torch.float32, name
    for S in (16, 13):
        toks = jnp.asarray(_tokens(cfg, (2, S), seed=4))
        want = np.asarray(jax_bundle(jcfg32).prefill(jcfg32, jparams32, toks)[0])
        jerr = np.abs(np.asarray(jax_bundle(jcfg).prefill(jcfg, jparams, toks)[0],
                                 np.float32) - want)
        logits, _ = X.prefill(cfg, params, torch.tensor(np.asarray(toks)))
        assert logits.dtype == torch.bfloat16
        err = np.abs(logits.float().numpy() - want)
        assert err.max() <= BF16_SLACK * jerr.max() and \
            err.mean() <= BF16_SLACK * jerr.mean(), (S, err.max(), jerr.max())


def test_decode_matches_jax_bf16():
    """bf16 ``decode_step`` against JAX's at 3e-2, both from JAX's prefill
    cache (cells in f32, conv windows in bf16)."""
    jcfg, jparams, cfg, params = _pair("bfloat16")
    jb = jax_bundle(jcfg)
    toks = _tokens(cfg, (2, 19), seed=6)
    _, jcache = jb.prefill(jcfg, jparams, jnp.asarray(toks[:, :16]))
    cache = {k: (torch.tensor(np.asarray(v.astype(jnp.float32))).to(torch.bfloat16)
                 if v.dtype == jnp.bfloat16 else torch.from_numpy(np.array(v)))
             for k, v in jcache.items()}
    assert cache["m_conv"].dtype == torch.bfloat16 and cache["m_C"].dtype == torch.float32
    for i in range(16, 19):
        jlog, jcache = jb.decode_step(jcfg, jparams, jcache, jnp.asarray(toks[:, i:i + 1]))
        logits, cache = X.decode_step(cfg, params, cache, torch.from_numpy(toks[:, i:i + 1]))
        assert logits.dtype == torch.bfloat16
        _close(logits, jlog, tol=3e-2)


def test_init_cache_matches_jax():
    jcfg, _, cfg, _ = _pair("bfloat16")
    jcache = jax_bundle(jcfg).init_cache(jcfg, 3, 8)
    cache = X.init_cache(cfg, 3, 8, device=CPU)
    for name, want in jcache.items():
        assert tuple(cache[name].shape) == want.shape, name
        assert cache[name].dtype == getattr(torch, str(want.dtype)), name
        _close(cache[name], want)


# ---------------------------------------------------------------------------
# weights and init
# ---------------------------------------------------------------------------

def test_weights_cross_both_ways():
    """The (G, slstm_every - 1) stacks of ``mlstm/...``, the (G,) stacks of
    ``slstm/...``, the f32 gates in a bf16 model: the round trip is exact."""
    jcfg, jparams, cfg, params = _pair("bfloat16")
    arrays = _flatten(jparams)
    G, m_per = X.n_groups(cfg), cfg.slstm_every - 1
    assert arrays["mlstm/mlstm/w_qkv"].shape[:2] == (G, m_per)
    assert arrays["slstm/slstm/r_gates"].shape[0] == G
    back = params_to_jax(params)
    assert sorted(back) == sorted(arrays)
    for key, arr in arrays.items():
        np.testing.assert_array_equal(back[key], np.asarray(arr, np.float32), err_msg=key)
    assert sum(p.numel() for p in params.parameters()) == sum(a.size for a in arrays.values())


def test_init_is_seeded_and_shaped():
    cfg = smoke_of(ARCH)
    a, b = X.init(cfg, 3, device=CPU), X.init(cfg, 3, device=CPU)
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    m, s = a.mlstm[1][0].mlstm, a.slstm[0].slstm
    H, D = cfg.n_heads, cfg.d_model
    want_m = torch.cat([torch.zeros(H), torch.linspace(3.0, 6.0, H)])
    want_s = torch.cat([torch.zeros(2 * D), torch.full((D,), 3.0), torch.zeros(D)])
    assert torch.equal(m.b_gates, want_m) and torch.equal(s.b_gates, want_s)
    assert bool((m.gn == 1).all() and (s.gn == 1).all())
    assert all(t.dtype == torch.float32 for t in (m.w_if, m.b_gates, s.w_gates, s.r_gates))
    assert m.w_qkv.dtype == torch.bfloat16
    hd = D // H
    assert abs(float(s.r_gates.std()) - hd ** -0.5) < 0.1 * hd ** -0.5
    assert abs(float(m.conv_w.float().std()) - 0.1) < 0.03


# ---------------------------------------------------------------------------
# loss_fn and every gradient
# ---------------------------------------------------------------------------

def _batch(cfg, B, S, seed=0):
    toks = _tokens(cfg, (B, S + 1), seed)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@functools.lru_cache(maxsize=None)
def _jax_value_and_grads(dtype, remat, S, seed):
    jcfg, jparams, cfg, _ = _pair(dtype)
    batch = _batch(cfg, 2, S, seed)
    loss_fn = jax_bundle(jcfg).loss_fn
    jl, jg = jax.value_and_grad(lambda p: loss_fn(
        jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}, remat=remat))(jparams)
    return float(jl), {k: np.asarray(v, np.float32) for k, v in _flatten(jg).items()}


def _port_value_and_grads(dtype, remat, S, seed):
    _, _, cfg, params = _pair(dtype)
    batch = _batch(cfg, 2, S, seed)
    leaves = list(params.parameters())
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = X.loss_fn(cfg, params, {k: torch.tensor(v) for k, v in batch.items()},
                         remat=remat)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.item(), named_to_jax(zip((n for n, _ in params.named_parameters()), grads))


# tokens: one chunk (the parallel form), three chunks (chunkwise), and a
# length off the chunk (the chunkwise form's parallel fallback)
LENGTHS = [8, 24, 12]


@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("remat", REMATS)
def test_loss_fn_and_every_gradient_match_jax(remat, S):
    jl, jg = _jax_value_and_grads("float32", remat, S, 0)
    tl, tg = _port_value_and_grads("float32", remat, S, 0)
    assert abs(tl - jl) <= TOL * (1 + abs(jl))
    assert set(tg) == set(jg) and "slstm/slstm/r_gates" in tg
    for key in jg:
        _close(tg[key], jg[key])


@functools.lru_cache(maxsize=None)
def _token_losses(dtype, S, seed):
    """Each token's next-token loss (f32), JAX's and the port's: the logits
    in the model's dtype, an f32 cross entropy; once per case (the remat
    policy does not enter)."""
    from repro.models import transformer as JT
    from repro_torch.models import transformer as T
    jcfg, jparams, cfg, params = _pair(dtype)
    batch = _batch(cfg, 2, S, seed)
    jlog = JT.logits_of(jcfg, jparams, JX.hidden(jcfg, jparams, jnp.asarray(batch["tokens"])))
    jlog = np.asarray(jlog, np.float32)
    jtok = (np.log(np.exp(jlog - jlog.max(-1, keepdims=True)).sum(-1)) + jlog.max(-1)
            - np.take_along_axis(jlog, batch["labels"][..., None], -1)[..., 0])
    with torch.no_grad():
        logits = T.logits_of(cfg, params, X.hidden(cfg, params, torch.from_numpy(batch["tokens"])))
        ttok = torch.nn.functional.cross_entropy(logits.float().flatten(0, 1),
                                                 torch.from_numpy(batch["labels"]).long()
                                                 .flatten(), reduction="none")
    return jtok.reshape(-1), ttok.numpy()


@pytest.mark.parametrize("S", [8, 24])
@pytest.mark.parametrize("remat", REMATS)
def test_loss_fn_and_every_gradient_match_jax_bf16(remat, S):
    """Against JAX's f32 results, the port's bf16 error at most 1.5x JAX's
    bf16 error: each gradient tensor's relative (Euclidean) error, and that
    of the vector of the tokens' losses.  The mean loss's error is a sum of
    signed errors, as likely to cancel in one framework as in the other
    (at S = 24, seed 0: JAX 6.6e-4, the port 1.9e-3; seed 1: 7.2e-3 and
    6.6e-3), so the mean is held to the bf16 tolerance, 3e-2."""
    l32, g32 = _jax_value_and_grads("float32", remat, S, 0)
    tl, tg = _port_value_and_grads("bfloat16", remat, S, 0)
    _, jg = _jax_value_and_grads("bfloat16", remat, S, 0)
    assert abs(tl - l32) <= 3e-2
    for key, want in g32.items():
        norm = np.linalg.norm(want)
        et, ej = (np.linalg.norm(np.asarray(g, np.float32) - want) / norm
                  for g in (tg[key], jg[key]))
        assert et <= BF16_SLACK * ej, (key, et, ej)
    want, _ = _token_losses("float32", S, 0)
    jtok, ttok = _token_losses("bfloat16", S, 0)
    et, ej = (np.linalg.norm(t - want) / np.linalg.norm(want) for t in (ttok, jtok))
    assert et <= BF16_SLACK * ej, (et, ej)


def test_apply_and_serving_run_without_autograd():
    _, _, cfg, params = _pair()
    params.requires_grad_(True)
    try:
        tokens = torch.from_numpy(_tokens(cfg, (1, 16)))
        assert X.apply(cfg, params, tokens).grad_fn is None
        logits, cache = X.prefill(cfg, params, tokens)
        assert logits.grad_fn is None and cache["m_C"].grad_fn is None
        logits, _ = X.decode_step(cfg, params, cache, tokens[:, :1])
        assert logits.grad_fn is None
    finally:
        params.requires_grad_(False)


# ---------------------------------------------------------------------------
# the train step and a resumed run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_step_matches_jax(microbatch):
    """One AdamW step from equal weights: loss, gradient norm, the first
    moments at 2e-5, the parameters at 2e-5 plus 2% of one step, as the
    hybrid's (``tests/test_torch_hybrid_train.py``)."""
    jcfg = dataclasses.replace(jax_smoke(ARCH), dtype="float32")
    cfg = dataclasses.replace(smoke_of(ARCH), dtype="float32")
    jparams = jax_bundle(jcfg).init(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(_flatten(jparams), cfg, device=CPU).requires_grad_(True)
    batch = _batch(cfg, 4, 16, seed=8)
    lr, eps = 1e-3, 1e-8
    jopt, opt = JAdamW(lr=jconstant(lr), eps=eps), AdamW(lr=constant(lr), eps=eps)
    jstate, jm = jax.jit(jax_make_train_step(jcfg, jopt, microbatch=microbatch))(
        {"params": jparams, "opt": jopt.init(jparams)},
        {k: jnp.asarray(v) for k, v in batch.items()})
    state, tm = make_train_step(cfg, opt, microbatch=microbatch)(
        {"params": params, "opt": opt.init(params)},
        {k: torch.tensor(v) for k, v in batch.items()})
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
    """xlstm-smoke in f32: ``first`` trains 4 steps (checkpoints at 2 and
    4); from copies of its lake both frameworks resume to step 8 on the same
    batches, held to 1e-4 as the other families' runs are."""
    jcfg = dataclasses.replace(jax_smoke(ARCH), dtype="float32")
    cfg = dataclasses.replace(smoke_of(ARCH), dtype="float32")
    kw = dict(batch=2, seq=16, run_name="x", ckpt_every=2, seed=1)
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
    assert latest_step(tlake, "x") == 8
    template = jax.eval_shape(lambda k: jax_make_train_state(jcfg, k, JAdamW(lr=jconstant(0))),
                              jax.ShapeDtypeStruct((2,), jnp.uint32))
    jstate, step = jax_restore(tlake, "x", template)
    assert step == 8 and "slstm/slstm/r_gates" in _flatten(jstate["params"])
