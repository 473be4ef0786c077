"""PyTorch port, kernels: the plain attention versions against the JAX
oracles (``repro.kernels.ref``) and the Pallas kernels in interpret mode,
and the device dispatch of ``ops``.  The CUDA kernels themselves are held
against the plain versions in test_torch_kernels_cuda.py.

Inputs come from numpy with a fixed seed and go to both frameworks.
Tolerances are those of tests/test_kernels.py: 2e-5 in f32, 3e-2 in bf16.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import flash_decode as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_attention
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (MAX_SPLITS, TILE, decode_splits,
                                                    flash_decode)
from repro_torch.kernels.flash_attention import flash_attention

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _inputs(seed, *shapes, dtype="float32"):
    """Seeded numpy arrays, rounded to ``dtype``, as (jax, torch) pairs."""
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


# ---------------------------------------------------------------------------
# plain versions against the JAX oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Sq,Sk,H,K,hd,causal", [
    (2, 17, 17, 4, 2, 16, True),          # ragged prompt
    (1, 5, 23, 6, 3, 8, True),            # Sq != Sk: the last 5 positions
    (1, 13, 29, 4, 1, 32, False),
    (2, 64, 64, 14, 2, 64, True),         # qwen2 group 7
    (1, 40, 40, 4, 2, 128, True),         # qwen3 head dim
])
def test_attention_ref_matches_jax_oracle(B, Sq, Sk, H, K, hd, causal):
    (jq, tq), (jk, tk), (jv, tv) = _inputs(0, (B, Sq, H, hd), (B, Sk, K, hd),
                                           (B, Sk, K, hd))
    _close(ref.attention_ref(tq, tk, tv, causal=causal),
           jref.attention_ref(jq, jk, jv, causal=causal), TOL["float32"])


def test_attention_ref_matches_jax_oracle_bf16():
    (jq, tq), (jk, tk), (jv, tv) = _inputs(1, (1, 33, 4, 32),
                                           (1, 33, 2, 32), (1, 33, 2, 32),
                                           dtype="bfloat16")
    out = ref.attention_ref(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    _close(out, jref.attention_ref(jq, jk, jv), TOL["bfloat16"])


@pytest.mark.parametrize("B,Smax,H,K,hd,length", [
    (3, 50, 4, 2, 16, [1, 17, 50]),       # per-slot lengths, ragged Smax
    (2, 64, 14, 2, 8, [64, 3]),
    (2, 40, 6, 3, 32, 21),                # one scalar length
])
def test_decode_ref_matches_jax_oracle(B, Smax, H, K, hd, length):
    (jq, tq), (jk, tk), (jv, tv) = _inputs(2, (B, 1, H, hd), (B, Smax, K, hd),
                                           (B, Smax, K, hd))
    jlen = jnp.asarray(length, jnp.int32)
    tlen = torch.tensor(length, dtype=torch.int32)
    _close(ref.decode_attention_ref(tq, tk, tv, tlen),
           jref.decode_attention_ref(jq, jk, jv, jlen), TOL["float32"])


def test_decode_ref_per_slot_equals_one_slot_at_a_time():
    (_, tq), (_, tk), (_, tv) = _inputs(3, (3, 1, 4, 32), (3, 70, 2, 32), (3, 70, 2, 32))
    lengths = torch.tensor([4, 33, 70])
    out = ref.decode_attention_ref(tq, tk, tv, lengths)
    for b in range(3):
        one = ref.decode_attention_ref(tq[b:b + 1], tk[b:b + 1], tv[b:b + 1],
                                       int(lengths[b]))
        torch.testing.assert_close(out[b:b + 1], one, atol=1e-6, rtol=0)


@pytest.mark.parametrize("batch,kv_heads,smax,sms,want", [
    (8, 8, 2048, 132, 2),       # qwen3-1.7b decode on an H100's 132 SMs: 64 pairs
    (4, 32, 1024, 132, 1),      # zamba2: 128 pairs fill the SMs alone
    (4, 4, 512, 132, 4),        # qwen3-moe: 16 pairs, capped at one cluster of 4
    (1, 8, 8192, 132, 4),
    (64, 8, 1024, 132, 1),      # more pairs than SMs
    (1, 1, 1, 132, 1),          # one tile
    (1, 2, 130, 132, 3),        # three tiles
    (3, 2, 300, 78, 4),
])
def test_decode_splits_cover_every_slot_within_its_tiles(batch, kv_heads, smax, sms, want):
    """The bf16 kernel's blocks per (slot, KV head): at least one, at most
    one per tile of Smax and one cluster's worth (MAX_SPLITS), and no more
    blocks than SMs unless the pairs alone are more.  No length is among
    the inputs, so scalar and per-slot lengths launch one grid."""
    splits = decode_splits(batch, kv_heads, smax, sms)
    assert splits == want
    assert 1 <= splits <= min(-(-smax // TILE), MAX_SPLITS)
    assert batch * kv_heads * splits <= max(sms, batch * kv_heads)


# ---------------------------------------------------------------------------
# plain versions against the Pallas kernels (interpret mode), where those
# accept the input: divisible S, one scalar length
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Sq,Sk,H,K,hd,causal", [
    (1, 64, 64, 4, 2, 16, True),
    (1, 32, 64, 2, 1, 32, True),
    (1, 32, 32, 2, 2, 8, False),
])
def test_attention_ref_matches_pallas_kernel(B, Sq, Sk, H, K, hd, causal):
    (jq, tq), (jk, tk), (jv, tv) = _inputs(4, (B, Sq, H, hd), (B, Sk, K, hd),
                                           (B, Sk, K, hd))
    want = pallas_attention(jq, jk, jv, causal=causal, block_q=32, block_k=32,
                            interpret=True)
    _close(ref.attention_ref(tq, tk, tv, causal=causal), want, TOL["float32"])


@pytest.mark.parametrize("B,Smax,H,K,hd,length,bk", [
    (2, 128, 4, 2, 16, 77, 64),
    (1, 64, 6, 3, 32, 64, 32),
])
def test_decode_ref_matches_pallas_kernel(B, Smax, H, K, hd, length, bk):
    (jq, tq), (jk, tk), (jv, tv) = _inputs(5, (B, 1, H, hd), (B, Smax, K, hd),
                                           (B, Smax, K, hd))
    want = pallas_decode(jq, jk, jv, jnp.asarray(length), block_k=bk, interpret=True)
    _close(ref.decode_attention_ref(tq, tk, tv, length), want, TOL["float32"])


# ---------------------------------------------------------------------------
# dispatch: CPU tensors take the plain version; the kernels take CUDA only
# ---------------------------------------------------------------------------

def test_ops_sends_cpu_tensors_to_the_plain_versions():
    (_, q), (_, k), (_, v) = _inputs(6, (1, 9, 4, 64), (1, 9, 2, 64), (1, 9, 2, 64))
    before = (flash_attention.launches, flash_decode.launches)
    torch.testing.assert_close(ops.attention(q, k, v), ref.attention_ref(q, k, v),
                               atol=0, rtol=0)
    length = torch.tensor([9])
    torch.testing.assert_close(ops.decode_attention(q[:, :1], k, v, length),
                               ref.decode_attention_ref(q[:, :1], k, v, length),
                               atol=0, rtol=0)
    assert (flash_attention.launches, flash_decode.launches) == before


def test_kernels_refuse_cpu_tensors():
    (_, q), (_, k), (_, v) = _inputs(7, (1, 8, 4, 64), (1, 8, 2, 64), (1, 8, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode(q[:, :1], k, v, 8)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :32], k[..., :32], v[..., :32])
