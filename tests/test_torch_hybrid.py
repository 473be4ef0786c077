"""PyTorch port, Mamba2 / hybrid family: the SSD state scan's plain version
against the JAX oracle and the Pallas kernel (interpret mode), the chunked
SSD against JAX and against the step-by-step recurrence, and the
zamba2-smoke model (weights from the JAX ``bundle.init`` through
``interop``) against the JAX model, on the CPU.

Tolerances: 2e-5 in f32 (tests/test_kernels.py).  In bf16 the two
frameworks round at different places (silu, the conv's adds, the f32
casts) and four Mamba2 blocks grow that to ~0.05 in the logits, the size
of bf16's own error; so the bf16 case bounds the port's bf16 error against
the f32 logits by 1.5x the JAX bf16 error, as ``chip_smoke.py`` bounds the
kernels' path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _flatten
from repro.configs.base import smoke_of as jax_smoke
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_state_scan as pallas_scan
from repro.models import bundle_for as jax_bundle
from repro.models import mamba2 as JM
from repro.train.step import make_prefill as jax_make_prefill
from repro.train.step import make_serve_step as jax_make_serve_step
from repro_torch.configs.base import smoke_of
from repro_torch.interop import params_from_jax, params_to_jax
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import ssd_state_scan as cuda_scan
from repro_torch.models import bundle_for
from repro_torch.models import hybrid as H
from repro_torch.models import mamba2 as M
from repro_torch.train.step import make_prefill, make_serve_step

CPU = torch.device("cpu")
ARCH = "zamba2-2.7b"
KEY = jax.random.PRNGKey(0)


def _close(t_out, j_out, tol=2e-5):
    np.testing.assert_allclose(t_out.float().numpy(), np.asarray(j_out, np.float32),
                               atol=tol, rtol=tol)


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# state scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,C,H,P,N,with_init", [
    (2, 8, 4, 16, 16, False), (1, 16, 2, 32, 64, False), (3, 4, 1, 8, 8, False),
    (1, 4, 2, 8, 8, True), (2, 5, 4, 16, 16, True),
])
def test_ssd_state_scan_ref_matches_jax_and_pallas(B, C, H, P, N, with_init):
    rng = np.random.default_rng(B * 100 + C)
    xs = rng.standard_normal((B, C, H, P, N)).astype(np.float32)
    a = rng.uniform(0.3, 0.99, (B, C, H)).astype(np.float32)
    s0 = rng.standard_normal((B, H, P, N)).astype(np.float32) if with_init else None
    t_s0 = None if s0 is None else torch.from_numpy(s0)
    j_s0 = None if s0 is None else jnp.asarray(s0)
    prefix, final = ref.ssd_state_scan_ref(torch.from_numpy(xs), torch.from_numpy(a), t_s0)
    for jprefix, jfinal in (jref.ssd_state_scan_ref(jnp.asarray(xs), jnp.asarray(a), j_s0),
                            pallas_scan(jnp.asarray(xs), jnp.asarray(a), j_s0,
                                        interpret=True)):
        _close(prefix, jprefix)
        _close(final, jfinal)


def test_ops_ssd_state_scan_takes_the_plain_version_on_cpu():
    rng = np.random.default_rng(7)
    xs = torch.from_numpy(rng.standard_normal((1, 3, 2, 4, 4)).astype(np.float32))
    a = torch.from_numpy(rng.uniform(0.5, 0.9, (1, 3, 2)).astype(np.float32))
    before = cuda_scan.launches
    prefix, final = ops.ssd_state_scan(xs, a)
    assert torch.equal(prefix[:, 0], torch.zeros_like(final))    # zeros enter chunk 0
    want = ref.ssd_state_scan_ref(xs, a)
    assert torch.equal(prefix, want[0]) and torch.equal(final, want[1])
    assert cuda_scan.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        cuda_scan(xs, a)


# ---------------------------------------------------------------------------
# chunked SSD
# ---------------------------------------------------------------------------

def _ssd_inputs(cfg, B, S, seed):
    d_inner, Hh, P, N = M.dims(cfg)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, Hh, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, Hh)))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 4.0, Hh)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    d_skip = rng.standard_normal(Hh).astype(np.float32)
    return x, dt, a_log, Bm, Cm, d_skip


@pytest.mark.parametrize("S", [16, 32, 37])     # one chunk, two, ragged
def test_ssd_forward_matches_jax(S):
    cfg = dataclasses.replace(smoke_of(ARCH), dtype="float32")
    jcfg = dataclasses.replace(jax_smoke(ARCH), dtype="float32")
    args = _ssd_inputs(cfg, 2, S, seed=S)
    want = JM.ssd_forward(jcfg, *map(jnp.asarray, args))
    _close(M.ssd_forward(cfg, *map(torch.from_numpy, args)), want)


def test_ssd_chunked_matches_sequential():
    """Chunked SSD == naive per-step recurrence, and its final state is the
    recurrence's last state."""
    cfg = smoke_of(ARCH)
    x, dt, a_log, Bm, Cm, _ = map(torch.from_numpy, _ssd_inputs(cfg, 2, 32, seed=9))
    d_skip = torch.zeros(x.shape[2])
    y_chunk, final = M.ssd_chunked(cfg, x, dt, a_log, Bm, Cm, d_skip)
    A = -torch.exp(a_log)
    state = torch.zeros(x.shape[0], x.shape[2], x.shape[3], Bm.shape[-1])
    ys = []
    for t in range(x.shape[1]):
        a_t = torch.exp(dt[:, t] * A)
        upd = (dt[:, t, :, None] * x[:, t])[..., None] * Bm[:, t, None, None, :]
        state = a_t[..., None, None] * state + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cm[:, t]))
    torch.testing.assert_close(y_chunk, torch.stack(ys, dim=1), atol=2e-4, rtol=2e-3)
    torch.testing.assert_close(final, state, atol=2e-4, rtol=2e-3)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _pair(dtype="float32"):
    jcfg = dataclasses.replace(jax_smoke(ARCH), dtype=dtype)
    cfg = dataclasses.replace(smoke_of(ARCH), dtype=dtype)
    jparams = jax_bundle(jcfg).init(jcfg, KEY)
    return jcfg, jparams, cfg, params_from_jax(_flatten(jparams), cfg, device=CPU)


@pytest.fixture(scope="module")
def f32_run():
    """The JAX side, once: apply on 21 tokens; prefill of 19 of 22 tokens
    (two chunks of 16, one ragged) then three decode steps, through
    ``train/step.py``; prefill of 22 for the continuation check."""
    jcfg, jparams, cfg, params = _pair()
    jb = jax_bundle(jcfg)
    toks = _tokens(cfg, (2, 22))
    out = {"apply": jb.apply(jcfg, jparams, jnp.asarray(toks[:, :21]))}
    jlog, jcache = jax_make_prefill(jcfg)(jparams, {"tokens": jnp.asarray(toks[:, :19])},
                                          max_seq=24)
    out["prefill"] = jlog
    out["cache"] = {k: np.asarray(v) for k, v in jcache.items()}
    step = jax_make_serve_step(jcfg)
    out["decode"] = []
    for i in range(19, 22):
        jlog, jcache = step(jparams, jcache, jnp.asarray(toks[:, i:i + 1]))
        out["decode"].append(jlog)
    out["cache_after"] = {k: np.asarray(v) for k, v in jcache.items()}
    return cfg, params, toks, out


def test_apply_matches_jax(f32_run):
    cfg, params, toks, want = f32_run
    _close(H.apply(cfg, params, torch.from_numpy(toks[:, :21])), want["apply"])


def test_prefill_matches_jax(f32_run):
    cfg, params, toks, want = f32_run
    logits, cache = make_prefill(cfg)(params, {"tokens": torch.from_numpy(toks[:, :19])},
                                      max_seq=24)
    _close(logits, want["prefill"])
    assert sorted(cache) == sorted(want["cache"])
    for name in ("state", "conv", "k", "v"):
        assert tuple(cache[name].shape) == want["cache"][name].shape, name
        _close(cache[name], want["cache"][name])
    assert int(cache["index"]) == 19


def test_decode_matches_jax(f32_run):
    cfg, params, toks, want = f32_run
    _, cache = H.prefill(cfg, params, torch.from_numpy(toks[:, :19]), max_seq=24)
    step = make_serve_step(cfg)
    for i, jlog in zip(range(19, 22), want["decode"]):
        logits, cache = step(params, cache, torch.from_numpy(toks[:, i:i + 1]))
        _close(logits, jlog)
    for name in ("state", "conv", "k", "v"):
        _close(cache[name], want["cache_after"][name])
    assert int(cache["index"]) == 22


def test_hybrid_decode_matches_prefill_continuation(f32_run):
    """prefill(S) then one decode step == prefill(S+1) last logits."""
    cfg, params, toks, _ = f32_run
    t = torch.from_numpy(toks[:1, :17])
    lg_full, _ = H.prefill(cfg, params, t, max_seq=32)
    _, cache = H.prefill(cfg, params, t[:, :16], max_seq=32)
    lg_dec, _ = H.decode_step(cfg, params, cache, t[:, 16:17])
    torch.testing.assert_close(lg_dec[:, 0], lg_full[:, -1], atol=2e-5, rtol=2e-5)


def test_short_prompt_pads_the_conv_cache_with_zeros(f32_run):
    """A prompt shorter than K-1 keeps the conv's zero padding in front,
    so decoding after it equals decoding the same tokens from the start."""
    cfg, params, toks, _ = f32_run
    t = torch.from_numpy(toks[:1, :4])
    _, cache = H.prefill(cfg, params, t[:, :2], max_seq=8)
    assert bool((cache["conv"][:, :, 0] == 0).all())
    lg_a, cache = H.decode_step(cfg, params, cache, t[:, 2:3])
    lg_full, _ = H.prefill(cfg, params, t[:, :3], max_seq=8)
    torch.testing.assert_close(lg_a[:, 0], lg_full[:, -1], atol=2e-5, rtol=2e-5)


def test_prefill_matches_jax_bf16():
    """bf16 prefill logits err against the f32 logits at most 1.5x as much
    as the JAX package's bf16 prefill does (max and mean)."""
    toks = jnp.asarray(_tokens(smoke_of(ARCH), (2, 9), seed=4))
    jcfg32, jparams32, _, _ = _pair()
    want = np.asarray(jax_bundle(jcfg32).prefill(jcfg32, jparams32, toks)[0])
    jcfg, jparams, cfg, params = _pair("bfloat16")
    assert params.mamba[0][0].ssm.in_proj.dtype == torch.bfloat16
    assert params.mamba[0][0].ssm.a_log.dtype == torch.float32
    jerr = np.abs(np.asarray(jax_bundle(jcfg).prefill(jcfg, jparams, toks)[0],
                             np.float32) - want)
    logits, _ = H.prefill(cfg, params, torch.from_numpy(np.asarray(toks)))
    assert logits.dtype == torch.bfloat16
    err = np.abs(logits.float().numpy() - want)
    assert err.max() <= 1.5 * jerr.max() and err.mean() <= 1.5 * jerr.mean(), \
        (err.max(), jerr.max(), err.mean(), jerr.mean())


def _cache_from_jax(jcache):
    """The JAX cache as the port's tensors: bf16 stays bf16 (exactly, through
    f32), f32 and int32 keep their type."""
    out = {}
    for name, a in jcache.items():
        a = jnp.asarray(a)
        if a.dtype == jnp.bfloat16:
            out[name] = torch.tensor(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
        else:
            out[name] = torch.from_numpy(np.array(a))
    return out


def test_silu_rounds_as_the_reference_in_bf16():
    """``layers.silu`` equals ``jax.nn.silu`` bit for bit in bf16 (XLA
    rounds each op of x * (1 / (1 + exp(-x)))); ``F.silu``, rounding once,
    does not."""
    from repro_torch.models import layers
    x = (np.random.default_rng(7).standard_normal(20_000) * 4).astype(np.float32)
    t = torch.from_numpy(x).to(torch.bfloat16)
    want = torch.from_numpy(np.asarray(jax.nn.silu(jnp.asarray(x, jnp.bfloat16)), np.float32))
    assert torch.equal(layers.silu(t).float(), want)
    assert not torch.equal(torch.nn.functional.silu(t).float(), want)


def test_decode_matches_jax_bf16():
    """bf16 ``decode_step`` against JAX's at 3e-2: both start from the JAX
    prefill's cache (SSD states in f32, conv windows and K/V in bf16; the
    first 9 tokens of each prompt) and decode three tokens, each on its own
    cache from then on.  The Mamba2 blocks round ``silu`` as the reference
    does (``layers.silu``); with ``F.silu`` this test fails."""
    jcfg, jparams, cfg, params = _pair("bfloat16")
    jb = jax_bundle(jcfg)
    toks = _tokens(cfg, (2, 12), seed=4)
    _, jcache = jb.prefill(jcfg, jparams, jnp.asarray(toks[:, :9]), max_seq=12)
    cache = _cache_from_jax(jcache)
    assert cache["conv"].dtype == torch.bfloat16 and cache["state"].dtype == torch.float32
    for i in range(9, 12):
        jlog, jcache = jb.decode_step(jcfg, jparams, jcache, jnp.asarray(toks[:, i:i + 1]))
        logits, cache = H.decode_step(cfg, params, cache, torch.from_numpy(toks[:, i:i + 1]))
        assert logits.dtype == torch.bfloat16
        _close(logits, jlog, tol=3e-2)
    assert int(cache["index"]) == 12


def test_serve_steps_cover_both_families():
    """``make_prefill`` / ``make_serve_step`` resolve each family's bundle."""
    for arch in ("qwen3-moe-30b-a3b", "zamba2-2.7b", "qwen3-1.7b"):
        cfg = smoke_of(arch)
        params = bundle_for(cfg).init(cfg, 0, device=CPU)
        toks = torch.from_numpy(_tokens(cfg, (2, 5), seed=6))
        logits, cache = make_prefill(cfg)(params, {"tokens": toks}, max_seq=8)
        assert logits.shape == (2, 1, cfg.vocab) and int(cache["index"]) == 5
        logits, cache = make_serve_step(cfg)(params, cache, toks[:, :1])
        assert logits.shape == (2, 1, cfg.vocab) and int(cache["index"]) == 6
        assert bool(torch.isfinite(logits.float()).all())


def test_weights_cross_both_ways():
    """The doubly stacked ``mamba/...`` keys, the singly stacked adapters and
    the unstacked ``shared/...`` block survive the round trip exactly."""
    jcfg, jparams, cfg, params = _pair()
    arrays = _flatten(jparams)
    n_super = cfg.n_layers // cfg.attn_every
    assert arrays["mamba/ssm/in_proj"].shape[:2] == (n_super, cfg.attn_every)
    assert arrays["proj_in/w"].shape == (n_super, 2 * cfg.d_model, cfg.d_model)
    assert arrays["shared/attn/wq"].ndim == 2
    torch.testing.assert_close(params.mamba[1][0].ssm.a_log,
                               torch.tensor(arrays["mamba/ssm/a_log"][1, 0]))
    back = params_to_jax(params)
    assert sorted(back) == sorted(arrays)
    for key, arr in arrays.items():
        np.testing.assert_array_equal(back[key], arr, err_msg=key)


def test_weights_from_jax_are_checked():
    """Wrong stacked dims, a missing key and an unknown key are refused."""
    _, jparams, cfg, _ = _pair()
    arrays = _flatten(jparams)
    for change, error, match in (
            (lambda a: a.update({"mamba/ssm/a_log": a["mamba/ssm/a_log"][:1]}),
             ValueError, "leading dims"),
            (lambda a: a.pop("shared/attn/wq"), KeyError, "missing"),
            (lambda a: a.update({"extra/w": np.zeros(3, np.float32)}), KeyError, "extra/w")):
        bad = dict(arrays)
        change(bad)
        with pytest.raises(error, match=match):
            params_from_jax(bad, cfg, device=CPU)


def test_init_is_seeded_and_shaped():
    cfg = smoke_of(ARCH)
    a, b = H.init(cfg, 3, device=CPU), H.init(cfg, 3, device=CPU)
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    ssm = a.mamba[1][1].ssm
    _, Hh, _, _ = M.dims(cfg)
    torch.testing.assert_close(ssm.a_log, torch.log(torch.linspace(1.0, 16.0, Hh)))
    assert bool((ssm.dt_bias == 0).all() and (ssm.d_skip == 1).all())
    assert ssm.a_log.dtype == torch.float32 and ssm.in_proj.dtype == torch.bfloat16
    std = float(ssm.conv_w.float().std())
    assert abs(std - 0.1) < 0.03
    blk = M.init_ssm_block(cfg, 3, device=CPU)        # one block, drawn alike
    torch.testing.assert_close(blk.ssm.a_log, ssm.a_log)
    assert blk.ssm.out_proj.dtype == torch.bfloat16
