"""PyTorch port, MoE family: the router's plain version against the JAX
oracle and the Pallas kernel (interpret mode), the sort-based dispatch
``_local_moe`` against JAX, and the qwen3-moe-smoke model (weights from the
JAX ``bundle.init`` through ``interop``) against the JAX model, on the CPU.

Tolerances are those of tests/test_kernels.py: 2e-5 in f32, 3e-2 in bf16;
router ids are compared exactly, ties included.  The router's whole chain
(``moe_router_ref``: product, top-k, softmax) is held against the chain
the reference's ``_local_moe`` runs.
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
from repro.kernels.moe_gating import moe_gating as pallas_gating
from repro.models import bundle_for as jax_bundle
from repro.models import moe as JM
from repro.train.step import make_prefill as jax_make_prefill
from repro.train.step import make_serve_step as jax_make_serve_step
from repro_torch.configs.base import smoke_of
from repro_torch.interop import params_from_jax, params_to_jax
from repro_torch.kernels import ops, ref
from repro_torch.kernels.moe_gating import moe_gating as cuda_gating
from repro_torch.kernels.moe_gating import moe_router as cuda_router
from repro_torch.kernels.moe_gating import router_plan
from repro_torch.models import moe as M
from repro_torch.train.step import make_prefill, make_serve_step

CPU = torch.device("cpu")
ARCH = "qwen3-moe-30b-a3b"
KEY = jax.random.PRNGKey(0)


def _close(t_out, j_out, tol=2e-5):
    np.testing.assert_allclose(t_out.float().numpy(), np.asarray(j_out, np.float32),
                               atol=tol, rtol=tol)


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _logits(T, E, seed, tied=False):
    x = np.random.default_rng(seed).standard_normal((T, E)).astype(np.float32)
    if tied:                      # many exact ties, and one constant row
        x = np.round(x, 1)
        x[0] = 0.5
    return x


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,E,k,bt,tied", [
    (512, 128, 8, 128, False), (256, 8, 2, 64, False), (1024, 64, 4, 256, False),
    (64, 16, 1, 64, False), (256, 128, 8, 128, True), (64, 8, 2, 64, True),
])
def test_moe_gating_ref_matches_jax_and_pallas(T, E, k, bt, tied):
    x = _logits(T, E, seed=T + E + k, tied=tied)
    w, ids = ref.moe_gating_ref(torch.from_numpy(x), k)
    assert w.dtype == torch.float32 and ids.dtype == torch.int32
    for jw, jids in (jref.moe_gating_ref(jnp.asarray(x), k),
                     pallas_gating(jnp.asarray(x), k, block_t=bt, interpret=True)):
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        _close(w, jw)


def test_moe_gating_ref_breaks_ties_to_the_lowest_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0], [0.0, 0.0, 0.0, 0.0, 0.0]])
    w, ids = ref.moe_gating_ref(x, 3)
    assert ids.tolist() == [[1, 2, 4], [0, 1, 2]]
    torch.testing.assert_close(w.sum(-1), torch.ones(2))


def test_ops_moe_gating_takes_the_plain_version_on_cpu():
    x = torch.from_numpy(_logits(300, 64, seed=1))     # 300 % 256 != 0
    before = cuda_gating.launches
    w, ids = ops.moe_gating(x, 6)
    want_w, want_ids = ref.moe_gating_ref(x, 6)
    assert torch.equal(ids, want_ids) and torch.equal(w, want_w)
    assert cuda_gating.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        cuda_gating(x, 6)


def _router_inputs(T, D, E, dtype, dup, seed):
    """x (T,D) in ``dtype`` (as numpy f32 values it holds exactly) and the
    router (D,E) f32; ``dup`` repeats E//8 distinct columns 8 times, so the
    logits hold exact ties that both sides see bitwise equal."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, D)).astype(np.float32)
    if dtype == "bfloat16":
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    router = (rng.standard_normal((D, E)) * D ** -0.5).astype(np.float32)
    if dup:
        router = np.repeat(router[:, :E // 8], 8, axis=1)
    return x, router


@pytest.mark.parametrize("T,D,E,k,dtype,dup", [
    (4, 64, 8, 2, "bfloat16", False),       # the smoke config's decode
    (17, 64, 8, 2, "float32", False),       # ragged T
    (300, 128, 64, 6, "bfloat16", False),
    (33, 256, 128, 8, "float32", False),
    (64, 64, 128, 8, "bfloat16", True),     # duplicated columns: exact ties
    (5, 96, 16, 4, "float32", True),
])
def test_moe_router_ref_matches_jax(T, D, E, k, dtype, dup):
    x, router = _router_inputs(T, D, E, dtype, dup, seed=T + D + E)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    w, ids, probs = ref.moe_router_ref(tx, torch.from_numpy(router), k)
    assert (w.dtype, ids.dtype, probs.dtype) == (torch.float32, torch.int32, torch.float32)
    assert tuple(probs.shape) == (T, E)
    jlogits = jnp.asarray(x, getattr(jnp, dtype)).astype(jnp.float32) @ jnp.asarray(router)
    jw, jids = jref.moe_gating_ref(jlogits, k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(w, jw)
    _close(probs, jax.nn.softmax(jlogits, axis=-1))
    if dup:   # equal weights come in ascending ids: a tie goes to the lowest index
        assert bool(((w[:, 1:] != w[:, :-1]) | (ids[:, 1:] > ids[:, :-1])).all())
        assert bool((w[:, 1:] == w[:, :-1]).any())


def test_ops_moe_router_takes_the_plain_version_on_cpu():
    x, router = (torch.from_numpy(a) for a in _router_inputs(300, 64, 64, "float32",
                                                               False, seed=2))
    before = cuda_router.launches
    got = ops.moe_router(x.to(torch.bfloat16), router, 6)
    want = ref.moe_router_ref(x.to(torch.bfloat16), router, 6)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert cuda_router.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        cuda_router(x, router, 6)


@pytest.mark.parametrize("T,D,want", [
    (1, 2048, (0, 16)), (4, 2048, (0, 16)), (8, 64, (0, 2)), (4, 6144, (0, 16)),
    (17, 2048, (16, 8)), (300, 2048, (16, 8)), (1200, 2048, (80, 8)),
    (1200, 6144, (80, 16)), (1200, 8192, (80, 16)),
])
def test_router_plan_fits_the_kernels(T, D, want):
    """Up to 8 tokens take the decode kernel (rows 0) on one cluster of at
    most 16 blocks, each at least one 32-row chunk of D; more take the tile
    kernel, whose x slab (its rows of the block's D-slice, in f32) leaves
    room in the 227 KB of shared memory for one ring stage at E = 256."""
    rows, cluster = router_plan(T, D, sms=132)
    assert (rows, cluster) == want
    chunks = -(-D // 32)
    assert 1 <= cluster <= min(16, chunks)
    if rows:
        slab = rows * -(-chunks // cluster) * 32 * 4
        assert 128 + slab + (32 * 256 + 256) * 4 <= 227 * 1024


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _moe_cfgs(capacity_factor):
    return (dataclasses.replace(jax_smoke(ARCH), capacity_factor=capacity_factor),
            dataclasses.replace(smoke_of(ARCH), capacity_factor=capacity_factor))


def _moe_layer(jp, cfg):
    layer = M.MoE(cfg, device=CPU, dtype=torch.float32)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            p.copy_(torch.tensor(np.asarray(jp[name], np.float32)))
    return layer


@pytest.mark.parametrize("capacity_factor", [8.0, 0.05])
def test_local_moe_matches_jax(capacity_factor):
    """No drops (capacity 8x), and most assignments dropped (0.05)."""
    jcfg, cfg = _moe_cfgs(capacity_factor)
    jp = JM.init_moe(jcfg, KEY, jnp.float32)
    x = np.random.default_rng(3).standard_normal((64, cfg.d_model)).astype(np.float32)
    jy, (jf, jpr) = JM._local_moe(jcfg, jnp.asarray(x), jp, 0, jcfg.n_experts)
    y, (f, pr) = M._local_moe(cfg, torch.from_numpy(x), _moe_layer(jp, cfg), 0,
                              cfg.n_experts)
    _close(y, jy)
    _close(f, jf)
    _close(pr, jpr)


def test_moe_local_dispatch_matches_dense():
    """Sort-based capacity dispatch == dense per-expert loop (no drops)."""
    jcfg, cfg = _moe_cfgs(8.0)
    p = _moe_layer(JM.init_moe(jcfg, KEY, jnp.float32), cfg)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (64, cfg.d_model)).astype(np.float32))
    y, (f_e, _) = M._local_moe(cfg, x, p, 0, cfg.n_experts)
    assert float(f_e.sum()) > 0           # load-balance stats present
    w, ids = ref.moe_gating_ref(x @ p.router, cfg.top_k)
    y_ref = torch.zeros_like(x)
    for e in range(cfg.n_experts):
        o = (torch.nn.functional.silu(x @ p.w_gate[e]) * (x @ p.w_up[e])) @ p.w_down[e]
        y_ref += o * ((ids == e).float() * w).sum(-1, keepdim=True)
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=1e-3)


def test_moe_capacity_drops_tokens():
    jcfg, cfg = _moe_cfgs(0.05)
    p = _moe_layer(JM.init_moe(jcfg, KEY, jnp.float32), cfg)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (64, cfg.d_model)).astype(np.float32))
    y, _ = M._local_moe(cfg, x, p, 0, cfg.n_experts)
    assert bool(torch.isfinite(y).all())  # drops must not produce NaNs
    # cap 8 slots for each of 8 experts < 128 assignments: some tokens lose
    # at least one of their experts, so y differs from the drop-free output
    y_all, _ = M._local_moe(dataclasses.replace(cfg, capacity_factor=8.0), x, p)
    assert not torch.allclose(y, y_all)


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
    """The JAX side, once: apply (and the load-balance aux) on 11 tokens,
    prefill of 7 of 10 tokens then three decode steps, through the bundle
    and ``train/step.py``."""
    jcfg, jparams, cfg, params = _pair()
    jb = jax_bundle(jcfg)
    toks = _tokens(cfg, (2, 11))
    out = {"apply": jb.apply(jcfg, jparams, jnp.asarray(toks)),
           "aux": JM.hidden(jcfg, jparams, jnp.asarray(toks))[1]}
    jlog, jcache = jax_make_prefill(jcfg)(jparams, {"tokens": jnp.asarray(toks[:, :7])},
                                          max_seq=12)
    out["prefill"], out["cache_k"] = jlog, jcache["k"]
    step = jax_make_serve_step(jcfg)
    out["decode"] = []
    for i in range(7, 10):
        jlog, jcache = step(jparams, jcache, jnp.asarray(toks[:, i:i + 1]))
        out["decode"].append(jlog)
    out["cache_v"] = jcache["v"]
    return cfg, params, toks, out


def test_apply_matches_jax(f32_run):
    cfg, params, toks, want = f32_run
    _close(M.apply(cfg, params, torch.from_numpy(toks)), want["apply"])


def test_hidden_returns_the_load_balance_aux(f32_run):
    cfg, params, toks, want = f32_run
    _, aux = M.hidden(cfg, params, torch.from_numpy(toks))
    _close(aux, want["aux"])


def test_prefill_and_decode_match_jax(f32_run):
    """Through the serve steps of ``train/step.py``, as the JAX dry-run's
    prefill and decode cells call the bundle."""
    cfg, params, toks, want = f32_run
    logits, cache = make_prefill(cfg)(params, {"tokens": torch.from_numpy(toks[:, :7])},
                                      max_seq=12)
    _close(logits, want["prefill"])
    _close(cache["k"][:, :, :7], np.asarray(want["cache_k"])[:, :, :7])
    step = make_serve_step(cfg)
    for i, jlog in zip(range(7, 10), want["decode"]):
        logits, cache = step(params, cache, torch.from_numpy(toks[:, i:i + 1]))
        _close(logits, jlog)
    _close(cache["v"], want["cache_v"])
    assert int(cache["index"]) == 10


def test_prefill_matches_jax_bf16():
    jcfg, jparams, cfg, params = _pair("bfloat16")
    assert params.blocks[0].moe.w_gate.dtype == torch.bfloat16
    assert params.blocks[0].moe.router.dtype == torch.float32
    toks = _tokens(cfg, (1, 9), seed=4)
    jlog, _ = jax_bundle(jcfg).prefill(jcfg, jparams, jnp.asarray(toks))
    logits, _ = M.prefill(cfg, params, torch.from_numpy(toks))
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
    jcfg, jparams, cfg, params = _pair("bfloat16")
    jb = jax_bundle(jcfg)
    toks = _tokens(cfg, (1, 12), seed=4)
    _, jcache = jb.prefill(jcfg, jparams, jnp.asarray(toks[:, :9]), max_seq=12)
    cache = _cache_from_jax(jcache)
    assert cache["k"].dtype == torch.bfloat16
    for i in range(9, 12):
        jlog, jcache = jb.decode_step(jcfg, jparams, jcache, jnp.asarray(toks[:, i:i + 1]))
        logits, cache = M.decode_step(cfg, params, cache, torch.from_numpy(toks[:, i:i + 1]))
        assert logits.dtype == torch.bfloat16
        _close(logits, jlog, tol=3e-2)
    assert int(cache["index"]) == 12


def test_decode_matches_teacher_forcing():
    """Greedy decode logits == full-forward logits at the same positions,
    with drop-free capacity (decode routes one token at a time, so at the
    production capacity the full forward may drop what decode keeps)."""
    jcfg = dataclasses.replace(jax_smoke(ARCH), capacity_factor=8.0)
    cfg = dataclasses.replace(smoke_of(ARCH), capacity_factor=8.0)
    params = params_from_jax(_flatten(jax_bundle(jcfg).init(jcfg, KEY)), cfg, device=CPU)
    toks = torch.from_numpy(_tokens(cfg, (1, 12), seed=5))
    full = M.apply(cfg, params, toks)
    _, cache = M.prefill(cfg, params, toks[:, :6], max_seq=12)
    outs = []
    for i in range(6, 12):
        lg, cache = M.decode_step(cfg, params, cache, toks[:, i:i + 1])
        outs.append(lg)
    torch.testing.assert_close(torch.cat(outs, dim=1).float(), full[:, 6:12].float(),
                               atol=2e-2, rtol=2e-2)


def test_weights_cross_both_ways():
    jcfg, jparams, cfg, params = _pair()
    arrays = _flatten(jparams)
    assert arrays["blocks/moe/w_gate"].shape == (cfg.n_layers, cfg.n_experts, cfg.d_model,
                                                 cfg.d_ff)
    back = params_to_jax(params)
    assert sorted(back) == sorted(arrays)
    for key, arr in arrays.items():
        np.testing.assert_array_equal(back[key], arr, err_msg=key)


def test_init_is_seeded_and_shaped():
    cfg = smoke_of(ARCH)
    a, b = M.init(cfg, 3, device=CPU), M.init(cfg, 3, device=CPU)
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    moe = a.blocks[1].moe
    assert moe.router.dtype == torch.float32 and moe.w_up.dtype == torch.bfloat16
    assert moe.w_down.shape == (cfg.n_experts, cfg.d_ff, cfg.d_model)
    std = float(moe.w_down.float().std())           # normal / sqrt(F)
    assert abs(std - cfg.d_ff ** -0.5) < 0.2 * cfg.d_ff ** -0.5
    layer = M.init_moe(cfg, 3, device=CPU)           # one layer, drawn alike
    assert layer.router.dtype == torch.float32 and layer.w_gate.shape == moe.w_gate.shape
