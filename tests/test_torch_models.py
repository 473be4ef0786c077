"""PyTorch port, dense model: the same weights (JAX ``bundle.init``,
flattened as the checkpoint flattens them, through ``interop``) and the same
tokens through the JAX model and the port, on the CPU.

Configs: lidc-demo-smoke, qwen2-smoke (QKV bias, head dim 8, group 7),
qwen3-smoke (qk_norm) and chameleon-smoke (the vlm family on the dense
decoder, qk_norm, rope theta 1e4) in f32 at 2e-5; one bf16 case at 3e-2;
phi4-smoke, mistral-smoke and grok-1-smoke (MoE) in f32 at 2e-5.
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
from repro.configs.base import get_config as jax_config
from repro.configs.base import smoke_of as jax_smoke
from repro.models import bundle_for as jax_bundle
from repro.models import param_count as jax_param_count
from repro_torch.configs.base import SHAPES, get_config, smoke_of
from repro_torch.interop import params_from_jax, params_to_jax
from repro_torch.models import bundle_for, memory_estimate, param_count
from repro_torch.models import transformer as T

CPU = torch.device("cpu")
ARCHS = ["lidc-demo", "qwen2-0.5b", "qwen3-1.7b", "chameleon-34b"]


def _pair(arch, dtype="float32"):
    """(jax cfg, jax params, torch cfg, torch params) with equal weights."""
    jcfg = dataclasses.replace(jax_smoke(arch), dtype=dtype)
    cfg = dataclasses.replace(smoke_of(arch), dtype=dtype)
    jparams = jax_bundle(jcfg).init(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, cfg, params_from_jax(_flatten(jparams), cfg, device=CPU)


@pytest.fixture(scope="module", params=ARCHS)
def f32_pair(request):
    return _pair(request.param)


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _close(t_out, j_out, tol=2e-5):
    np.testing.assert_allclose(t_out.float().numpy(), np.asarray(j_out, np.float32),
                               atol=tol, rtol=tol)


def test_configs_match_jax():
    for arch in ARCHS + ["phi4-mini-3.8b", "qwen3-moe-30b-a3b", "zamba2-2.7b", "xlstm-350m",
                         "seamless-m4t-large-v2", "mistral-large-123b", "grok-1-314b"]:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_config(arch))
        assert dataclasses.asdict(smoke_of(arch)) == dataclasses.asdict(jax_smoke(arch))


def test_weights_cross_both_ways(f32_pair):
    jcfg, jparams, cfg, params = f32_pair
    arrays = _flatten(jparams)
    back = params_to_jax(params)
    assert sorted(back) == sorted(arrays)
    for key, arr in arrays.items():
        np.testing.assert_array_equal(back[key], arr, err_msg=key)
    assert param_count(cfg) == jax_param_count(jcfg) == sum(a.size for a in arrays.values())


def test_param_count_and_memory_of_qwen3_1p7b_match_jax():
    from repro.models import memory_estimate as jax_memory
    cfg, jcfg = get_config("qwen3-1.7b"), jax_config("qwen3-1.7b")
    assert param_count(cfg) == jax_param_count(jcfg)
    assert cfg.param_count() == param_count(cfg)
    from repro.configs.base import SHAPES as JAX_SHAPES
    for name, shape in SHAPES.items():
        assert memory_estimate(cfg, shape, 4) == jax_memory(jcfg, JAX_SHAPES[name], 4)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "zamba2-2.7b", "xlstm-350m",
                                  "seamless-m4t-large-v2"])
def test_param_count_and_memory_of_moe_and_hybrid_match_jax(arch):
    """Full-size counts from the meta device (nothing allocated), the MoE's
    active count, and the hybrid's memory estimate, which counts only its
    n_layers // attn_every attention layers' cache."""
    from repro.configs.base import SHAPES as JAX_SHAPES
    from repro.models import memory_estimate as jax_memory
    cfg, jcfg = get_config(arch), jax_config(arch)
    for active_only in (False, True):
        assert param_count(cfg, active_only=active_only) == \
            jax_param_count(jcfg, active_only=active_only)
    for name, shape in SHAPES.items():
        assert memory_estimate(cfg, shape, 1) == jax_memory(jcfg, JAX_SHAPES[name], 1)


def test_apply_matches_jax(f32_pair):
    jcfg, jparams, cfg, params = f32_pair
    toks = _tokens(cfg, (2, 11))
    _close(T.apply(cfg, params, torch.from_numpy(toks)),
           jax_bundle(jcfg).apply(jcfg, jparams, jnp.asarray(toks)))


def test_prefill_and_decode_match_jax(f32_pair):
    """Last-position logits and the padded cache after prefill, then logits
    of three lockstep decode steps (scalar cache index)."""
    jcfg, jparams, cfg, params = f32_pair
    jb = jax_bundle(jcfg)
    toks = _tokens(cfg, (2, 10), seed=1)
    jlog, jcache = jb.prefill(jcfg, jparams, jnp.asarray(toks[:, :7]), max_seq=12)
    logits, cache = T.prefill(cfg, params, torch.from_numpy(toks[:, :7]), max_seq=12)
    _close(logits, jlog)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])
    assert int(cache["index"]) == int(jcache["index"]) == 7
    for i in range(7, 10):
        jlog, jcache = jb.decode_step(jcfg, jparams, jcache, jnp.asarray(toks[:, i:i + 1]))
        logits, cache = T.decode_step(cfg, params, cache, torch.from_numpy(toks[:, i:i + 1]))
        _close(logits, jlog)
    _close(cache["k"], jcache["k"])
    assert int(cache["index"]) == 10


def test_per_slot_decode_matches_jax(f32_pair):
    """Continuous-batching decode: every slot at its own position ((B,)
    index), as the serving engines run it."""
    jcfg, jparams, cfg, params = f32_pair
    jb = jax_bundle(jcfg)
    B, max_seq = 3, 16
    rng = np.random.default_rng(2)
    jcache = jb.init_cache(jcfg, B, max_seq)
    cache = T.init_cache(cfg, B, max_seq, device=CPU)
    for name in ("k", "v"):
        fill = rng.standard_normal(cache[name].shape).astype(np.float32)
        jcache[name] = jnp.asarray(fill)
        cache[name] = torch.tensor(fill)
    index = np.asarray([0, 5, 14], np.int32)
    jcache["index"] = jnp.asarray(index)
    cache["index"] = torch.tensor(index)
    toks = _tokens(cfg, (B, 1), seed=3)
    jlog, jcache = jb.decode_step(jcfg, jparams, jcache, jnp.asarray(toks))
    logits, cache = T.decode_step(cfg, params, cache, torch.from_numpy(toks))
    _close(logits, jlog)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])
    np.testing.assert_array_equal(cache["index"].numpy(), index + 1)


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "mistral-large-123b", "grok-1-314b"])
def test_remaining_smoke_configs_match_jax(arch):
    """phi4-smoke (group 3), mistral-smoke and grok-1-smoke (the MoE
    decoder, 8 experts top-2) in f32 at 2e-5, through each family's bundle
    and the serve steps: the weights' round trip, the logits, the prefill's
    logits and cache, three decode steps."""
    from repro_torch.train.step import make_prefill, make_serve_step
    jcfg, jparams, cfg, params = _pair(arch)
    arrays = _flatten(jparams)
    back = params_to_jax(params)
    assert sorted(back) == sorted(arrays) and param_count(cfg) == jax_param_count(jcfg)
    for key, arr in arrays.items():
        np.testing.assert_array_equal(back[key], arr, err_msg=key)
    jb, b = jax_bundle(jcfg), bundle_for(cfg)
    toks = _tokens(cfg, (2, 10), seed=1)
    _close(b.apply(cfg, params, torch.from_numpy(toks[:, :9])),
           jb.apply(jcfg, jparams, jnp.asarray(toks[:, :9])))
    jlog, jcache = jb.prefill(jcfg, jparams, jnp.asarray(toks[:, :7]), max_seq=12)
    logits, cache = make_prefill(cfg)(params, {"tokens": torch.from_numpy(toks[:, :7])},
                                      max_seq=12)
    _close(logits, jlog)
    _close(cache["k"], jcache["k"])
    step = make_serve_step(cfg)
    for i in range(7, 10):
        jlog, jcache = jb.decode_step(jcfg, jparams, jcache, jnp.asarray(toks[:, i:i + 1]))
        logits, cache = step(params, cache, torch.from_numpy(toks[:, i:i + 1]))
        _close(logits, jlog)
    _close(cache["v"], jcache["v"])
    assert int(cache["index"]) == 10


def test_prefill_matches_jax_bf16():
    jcfg, jparams, cfg, params = _pair("qwen3-1.7b", dtype="bfloat16")
    assert params.embed.table.dtype == torch.bfloat16
    toks = _tokens(cfg, (1, 9), seed=4)
    jlog, _ = jax_bundle(jcfg).prefill(jcfg, jparams, jnp.asarray(toks))
    logits, _ = T.prefill(cfg, params, torch.from_numpy(toks))
    assert logits.dtype == torch.bfloat16
    _close(logits, jlog, tol=3e-2)


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


def test_decode_matches_jax_bf16():
    """bf16 ``decode_step`` against JAX's at 3e-2: both start from the JAX
    prefill's cache (the prompt's first 9 tokens) and decode three tokens,
    each on its own cache from then on."""
    jcfg, jparams, cfg, params = _pair("qwen3-1.7b", dtype="bfloat16")
    jb = jax_bundle(jcfg)
    toks = _tokens(cfg, (1, 12), seed=4)
    _, jcache = jb.prefill(jcfg, jparams, jnp.asarray(toks[:, :9]), max_seq=12)
    cache = _cache_from_jax(jcache)
    assert cache["k"].dtype == torch.bfloat16
    for i in range(9, 12):
        jlog, jcache = jb.decode_step(jcfg, jparams, jcache, jnp.asarray(toks[:, i:i + 1]))
        logits, cache = T.decode_step(cfg, params, cache, torch.from_numpy(toks[:, i:i + 1]))
        assert logits.dtype == torch.bfloat16
        _close(logits, jlog, tol=3e-2)
    assert int(cache["index"]) == 12


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
    """Greedy decode logits == full-forward logits at the same positions
    (the config's own dtype, bf16, at the JAX test's 2e-2)."""
    cfg = smoke_of(arch)
    jcfg = jax_smoke(arch)
    params = params_from_jax(_flatten(jax_bundle(jcfg).init(jcfg, jax.random.PRNGKey(0))),
                             cfg, device=CPU)
    toks = torch.from_numpy(_tokens(cfg, (1, 12), seed=5))
    full = T.apply(cfg, params, toks)
    _, cache = T.prefill(cfg, params, toks[:, :6], max_seq=12)
    outs = []
    for i in range(6, 12):
        lg, cache = T.decode_step(cfg, params, cache, toks[:, i:i + 1])
        outs.append(lg)
    torch.testing.assert_close(torch.cat(outs, dim=1).float(), full[:, 6:12].float(),
                               atol=2e-2, rtol=2e-2)


def test_init_is_seeded_and_shaped():
    cfg = smoke_of("qwen3-1.7b")
    a = T.init(cfg, 3, device=CPU)
    b = T.init(cfg, 3, device=CPU)
    c = T.init(cfg, 4, device=CPU)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["embed.table"], sc["embed.table"])
    assert sa["blocks.1.attn.wq"].shape == (cfg.d_model, cfg.n_heads * cfg.hd)
    assert torch.equal(sa["blocks.0.attn.q_norm"], torch.ones(cfg.hd, dtype=torch.bfloat16))
    std = float(sa["blocks.0.mlp.w_down"].float().std())
    assert abs(std - cfg.d_ff ** -0.5) < 0.2 * cfg.d_ff ** -0.5


def test_bundle_for_is_dense_only():
    """Every family resolves (dense, vlm on the dense bundle, as the
    reference's ``bundle_for`` names it, moe, hybrid, ssm, encdec); a family
    the port does not know still raises.  The name is kept from when only
    the dense family was ported."""
    for arch, family in (("lidc-demo", "dense"), ("chameleon-34b", "dense"),
                         ("qwen3-moe-30b-a3b", "moe"), ("zamba2-2.7b", "hybrid"),
                         ("xlstm-350m", "ssm"), ("seamless-m4t-large-v2", "encdec")):
        assert bundle_for(smoke_of(arch)).family == family
        assert jax_bundle(jax_smoke(arch)).family == family
    for family in ("rnn", "diffusion"):
        with pytest.raises(ValueError, match="not ported"):
            bundle_for(dataclasses.replace(smoke_of("lidc-demo"), family=family))


def test_entry_points_need_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_of("lidc-demo")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_cache(cfg, 1, 8)
    assert T.init_cache(cfg, 1, 8, device="cpu")["k"].device == CPU


def test_port_imports_without_jax_or_repro():
    code = ("import sys; sys.modules['jax'] = None; "
            "import repro_torch, repro_torch.interop, repro_torch.serve.engine, "
            "repro_torch.launch.serve, repro_torch.kernels.ops, repro_torch.models.moe, "
            "repro_torch.models.mamba2, repro_torch.models.hybrid, "
            "repro_torch.models.xlstm, repro_torch.models.encdec, "
            "repro_torch.train.step, repro_torch.kernels.moe_gating, "
            "repro_torch.kernels.ssd_scan, repro_torch.train.trainer, "
            "repro_torch.launch.train, repro_torch.ckpt.checkpoint, "
            "repro_torch.data.pipeline, repro_torch.optim, repro_torch.lake, "
            "repro_torch.runtime, repro_torch.runtime.protocol, "
            "repro_torch.runtime.executors, repro_torch.runtime.fleet, "
            "repro_torch.runtime.pipeline, repro_torch.collectives, "
            "repro_torch.models.sharding, repro_torch.launch.mesh, "
            "repro_torch.optim.compress, repro_torch.examples.train_100m; "
            "bad = sorted(m for m, mod in sys.modules.items() if mod is not None and "
            "(m == 'repro' or m.startswith(('repro.', 'jax')))); print(bad); assert not bad")
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode == 0, out.stderr
