"""flash_decode at a GQA group above 8: the plain version against the JAX
oracle (``repro.kernels.ref``) and the Pallas kernel in interpret mode at
groups 12 (mistral-large-123b's 96 query heads over 8 KV heads) and 24, and
a decode step of a one-layer model at mistral-large's head layout, narrow
widths, against JAX.  The CUDA kernel's cases at these groups are in
``test_torch_kernels_cuda.py``.  Tolerances: 2e-5 f32, 3e-2 bf16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.kernels import ref as jref
from repro.kernels.decode_attention import flash_decode as pallas_decode
from repro.models.model import bundle_for as jax_bundle
from repro_torch.configs.base import get_config
from repro_torch.interop import params_from_jax
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import ROW_BLOCK, row_blocks
from repro_torch.models.model import bundle_for

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _inputs(seed, *shapes, dtype="float32"):
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        a = rng.standard_normal(shape).astype(np.float32)
        if dtype == "bfloat16":
            a = a.astype(ml_dtypes.bfloat16).astype(np.float32)
        out.append((jnp.asarray(a, dtype), torch.tensor(a, dtype=getattr(torch, dtype))))
    return out


def _close(t_out, j_out, tol):
    np.testing.assert_allclose(t_out.float().numpy(), np.asarray(j_out, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Smax,H,K,hd,length", [
    (2, 80, 96, 8, 16, [5, 80]),      # mistral-large's heads, narrow head dim
    (1, 64, 24, 2, 32, [33]),         # group 12
    (3, 50, 48, 2, 16, [1, 17, 50]),  # group 24: two row blocks of the kernel
    (2, 40, 24, 1, 32, 21),           # group 24, one scalar length
])
def test_decode_ref_at_large_groups_matches_jax_oracle(dtype, B, Smax, H, K, hd, length):
    (jq, tq), (jk, tk), (jv, tv) = _inputs(20, (B, 1, H, hd), (B, Smax, K, hd),
                                           (B, Smax, K, hd), dtype=dtype)
    out = ref.decode_attention_ref(tq, tk, tv, torch.tensor(length, dtype=torch.int32))
    assert out.dtype == getattr(torch, dtype)
    _close(out, jref.decode_attention_ref(jq, jk, jv, jnp.asarray(length, jnp.int32)),
           TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Smax,H,K,hd,length,bk", [
    (2, 128, 24, 2, 16, 77, 64),      # group 12
    (1, 64, 48, 2, 32, 64, 32),       # group 24
])
def test_decode_ref_at_large_groups_matches_pallas_kernel(dtype, B, Smax, H, K, hd, length,
                                                          bk):
    (jq, tq), (jk, tk), (jv, tv) = _inputs(21, (B, 1, H, hd), (B, Smax, K, hd),
                                           (B, Smax, K, hd), dtype=dtype)
    want = pallas_decode(jq, jk, jv, jnp.asarray(length), block_k=bk, interpret=True)
    _close(ref.decode_attention_ref(tq, tk, tv, length), want, TOL[dtype])


@pytest.mark.parametrize("group,blocks", [(1, 1), (8, 1), (9, 1), (12, 1), (16, 1),
                                          (17, 2), (24, 2), (32, 2), (33, 3)])
def test_row_blocks_cover_the_group(group, blocks):
    """Up to 8 query heads: the 8-row kernel; up to 16: one block of 16
    rows; above, ceil(group / 16) blocks, the last one partial."""
    assert row_blocks(group) == blocks
    if group > 8:
        assert (blocks - 1) * ROW_BLOCK < group <= blocks * ROW_BLOCK


def _mistral_one_layer(dtype):
    """mistral-large-123b's head layout (96 query heads over 8 KV heads,
    head dim 128) in one layer at narrow widths."""
    narrow = dict(n_layers=1, d_model=256, d_ff=128, vocab=256, head_dim=128, dtype=dtype)
    return (dataclasses.replace(get_config("mistral-large-123b"), **narrow),
            dataclasses.replace(jax_config("mistral-large-123b"), **narrow))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mistral_large_head_layout_decode_step_matches_jax(dtype):
    """Prefill of 9 tokens, then two decode steps, the port's against
    JAX's: the logits and the cache at group 12."""
    cfg, jcfg = _mistral_one_layer(dtype)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.hd) == (96, 8, 128)
    jb, tb = jax_bundle(jcfg), bundle_for(cfg)
    jparams = jb.init(jcfg, jax.random.PRNGKey(3))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    tparams = params_from_jax(flat, cfg, device="cpu")
    tokens = np.random.default_rng(22).integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    jl, jc = jb.prefill(jcfg, jparams, jnp.asarray(tokens), max_seq=16)
    tl, tc = tb.prefill(cfg, tparams, torch.tensor(tokens), max_seq=16)
    _close(tl, jl, TOL[dtype])
    for step in range(2):
        nxt = np.full((2, 1), 5 + step, np.int32)
        jl, jc = jb.decode_step(jcfg, jparams, jc, jnp.asarray(nxt))
        tl, tc = tb.decode_step(cfg, tparams, tc, torch.tensor(nxt))
        _close(tl, jl, TOL[dtype])
    _close(tc["k"], jc["k"], TOL[dtype])
    assert int(tc["index"]) == int(jc["index"]) == 11
