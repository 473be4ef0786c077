"""Building blocks of the dense decoder: norms, RoPE, GQA attention, SwiGLU
and embeddings, ported from ``repro/models/layers.py``.

Parameters live in small ``nn.Module``s whose attribute names are the JAX
parameter tree's keys, with weights laid out ``(d_in, d_out)`` and applied
as ``x @ w``, so weights cross between the frameworks unchanged
(``repro_torch.interop``).  Attention goes through ``kernels.ops``: the CUDA
kernels on the card, their plain versions on the CPU.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels import ops

__all__ = [
    "RMSNorm", "Embed", "Attention", "MLP", "init_weights_", "rms_norm", "silu",
    "embed_lookup", "rope_freqs", "apply_rope", "attention_block",
    "attention_decode", "mlp_block", "cross_entropy_loss", "chunked_lm_loss",
]

Offset = Union[int, torch.Tensor]


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.w = _param((d,), device, dtype)


class Embed(nn.Module):
    def __init__(self, vocab: int, d: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.table = _param((vocab, d), device, dtype)


class Attention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, n_kv: int, head_dim: int, *,
                 qkv_bias: bool = False, qk_norm: bool = False, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.wq = _param((d_model, n_heads * head_dim), device, dtype)
        self.wk = _param((d_model, n_kv * head_dim), device, dtype)
        self.wv = _param((d_model, n_kv * head_dim), device, dtype)
        self.wo = _param((n_heads * head_dim, d_model), device, dtype)
        if qkv_bias:
            self.bq = _param((n_heads * head_dim,), device, dtype)
            self.bk = _param((n_kv * head_dim,), device, dtype)
            self.bv = _param((n_kv * head_dim,), device, dtype)
        if qk_norm:
            self.q_norm = _param((head_dim,), device, dtype)
            self.k_norm = _param((head_dim,), device, dtype)


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.w_gate = _param((d_model, d_ff), device, dtype)
        self.w_up = _param((d_model, d_ff), device, dtype)
        self.w_down = _param((d_ff, d_model), device, dtype)


@torch.no_grad()
def init_weights_(model: nn.Module, seed: int, device: torch.device) -> nn.Module:
    """Fill every parameter in place from a ``torch.Generator`` seeded with
    ``seed``, as the JAX inits draw them: normal / sqrt(fan_in) for
    projections (fan_in the second-to-last dim: ``(d_in, d_out)`` weights and
    ``(E, d_in, d_out)`` experts alike), normal * 0.02 for the embedding,
    normal * 0.1 for the Mamba2 and xLSTM convs, ones for norms, the skip
    and the xLSTM group norms (``gn``), zeros for biases and ``dt_bias``,
    ``log(linspace(1, 16, H))`` for ``a_log``; the xLSTM gate biases as the
    reference sets them: the mLSTM's zeros(H) then linspace(3, 6, H), the
    sLSTM's zeros(2D), 3.0 (D) then zeros(D).  The sLSTM's recurrent
    ``r_gates`` (4, H, hd, hd) take normal / sqrt(hd), their fan-in.  Each
    parameter is drawn in f32 scratch of at most 4096 leading rows, then
    cast into place.  (The two frameworks' generators differ: for equal
    weights, use ``interop``.)"""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if p.dim() == 1 and leaf in ("w", "norm", "q_norm", "k_norm", "d_skip", "gn"):
            p.fill_(1.0)
        elif leaf in ("bq", "bk", "bv", "dt_bias"):
            p.zero_()
        elif leaf == "b_gates":
            p.zero_()
            if name.rsplit(".", 2)[-2] == "mlstm":      # (2H,): input, then forget
                H = p.shape[0] // 2
                p[H:] = torch.linspace(3.0, 6.0, H, device=device)
            else:                                       # (4D,): z, i, f, o
                D = p.shape[0] // 4
                p[2 * D:3 * D] = 3.0
        elif leaf == "a_log":
            p.copy_(torch.log(torch.linspace(1.0, 16.0, p.shape[0], device=device)))
        else:
            std = {"table": 0.02, "conv_w": 0.1}.get(leaf, 1.0 / math.sqrt(p.shape[-2]))
            for row in range(0, p.shape[0], 4096):
                chunk = p[row:row + 4096]
                chunk.copy_(torch.randn(chunk.shape, generator=gen, device=device) * std)
    return model


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def rms_norm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm over the last dim, computed in f32 and cast back."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) as the reference computes ``jax.nn.silu``: the
    logistic expanded to 1 / (1 + exp(-x)), every op rounded to x's dtype.
    In bf16 that rounds four times where ``F.silu`` rounds once, and the
    two differ in the last place on many inputs."""
    return x * (1 / (1 + torch.exp(-x)))


def embed_lookup(p: Embed, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, p.table)


# ---------------------------------------------------------------------------
# RoPE (half-rotation convention)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for positions: (..., head_dim/2), f32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (S, hd/2) or (B, S, hd/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:                      # (S, half) -> (1, S, 1, half)
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:                                   # (B, S, half) -> (B, S, 1, half)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _rope_tables(seq: int, head_dim: int, theta: float, offset: Offset,
                 device: torch.device):
    """A scalar offset gives (S, half) tables; a per-slot (B, 1) offset
    gives (B, S, half)."""
    pos = torch.arange(seq, device=device) + offset
    return rope_freqs(head_dim, theta, pos)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _project_qkv(p: Attention, x: torch.Tensor, n_heads: int, n_kv: int,
                 head_dim: int, theta: float, eps: float, pos_offset: Offset = 0):
    """Bias (qwen2), reshape to heads, per-head qk norm (qwen3), RoPE."""
    B, S, _ = x.shape
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if hasattr(p, "bq"):
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(B, S, n_heads, head_dim)
    k = k.reshape(B, S, n_kv, head_dim)
    v = v.reshape(B, S, n_kv, head_dim)
    if hasattr(p, "q_norm"):
        q = rms_norm(p.q_norm, q, eps)
        k = rms_norm(p.k_norm, k, eps)
    if theta > 0:
        cos, sin = _rope_tables(S, head_dim, theta, pos_offset, x.device)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _project_q(p: Attention, x: torch.Tensor, n_heads: int, head_dim: int, eps: float
               ) -> torch.Tensor:
    """q alone, as ``_project_qkv`` gives it without RoPE: (B, S, H, hd)."""
    q = x @ p.wq
    if hasattr(p, "bq"):
        q = q + p.bq
    q = q.reshape(*x.shape[:2], n_heads, head_dim)
    return rms_norm(p.q_norm, q, eps) if hasattr(p, "q_norm") else q


def attention_block(p: Attention, x: torch.Tensor, *, n_heads: int, n_kv: int,
                    head_dim: int, theta: float = 1e6, causal: bool = True,
                    eps: float = 1e-5,
                    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> torch.Tensor:
    """Full-sequence attention (training / prefill).

    ``kv_override`` supplies the encoder's K/V for cross-attention: q alone
    is projected from x, without RoPE, and the attention is not causal (the
    reference also projects K/V from x and drops them; the result is the
    same)."""
    B, S, _ = x.shape
    if kv_override is None:
        q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim, theta, eps)
    else:
        k, v = kv_override
        q = _project_q(p, x, n_heads, head_dim, eps)
        causal = False
    o = ops.attention(q, k, v, causal=causal)            # (B, S, H, hd)
    return o.reshape(B, S, n_heads * head_dim) @ p.wo


def attention_decode(p: Attention, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, index: torch.Tensor, *, n_heads: int,
                     n_kv: int, head_dim: int, theta: float = 1e6, eps: float = 1e-5
                     ) -> torch.Tensor:
    """One-token decode against a KV cache: x (B,1,D) -> out (B,1,D).

    cache_k/v: (B, S_max, K, hd); index: current length, a 0-dim int tensor
    for a lockstep batch or (B,) for continuous batching (per-slot
    positions).  Unlike the JAX version, which returns new caches, this
    writes the new K/V into ``cache_k``/``cache_v`` IN PLACE at ``index``
    (saving a copy of the cache per layer per step), then attends over
    ``index + 1`` positions.
    """
    B = x.shape[0]
    per_slot = index.dim() > 0
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim, theta, eps,
                           pos_offset=index[:, None] if per_slot else index)
    if per_slot:
        slots = torch.arange(B, device=x.device)
        cache_k[slots, index] = k[:, 0].to(cache_k.dtype)
        cache_v[slots, index] = v[:, 0].to(cache_v.dtype)
    else:   # written at the device-side index: the host never waits
        at = index.reshape(1).long()
        cache_k.index_copy_(1, at, k.to(cache_k.dtype))
        cache_v.index_copy_(1, at, v.to(cache_v.dtype))
    o = ops.decode_attention(q, cache_k, cache_v, index + 1)   # (B, 1, H, hd)
    return o.reshape(B, 1, n_heads * head_dim) @ p.wo


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_block(p: MLP, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU."""
    return (F.silu(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       z_loss: float = 0.0) -> torch.Tensor:
    """Mean token cross-entropy in f32.  logits (B,S,V), labels (B,S)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    loss = lse - gold
    if z_loss > 0:
        loss = loss + z_loss * lse ** 2
    return torch.mean(loss)


def _chunk_loss(xc: torch.Tensor, w_out: torch.Tensor, lc: torch.Tensor) -> torch.Tensor:
    logits = (xc @ w_out).float()           # the product in the parameter dtype
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
    return torch.sum(lse - gold)


def chunked_lm_loss(x: torch.Tensor, w_out: torch.Tensor, labels: torch.Tensor,
                    chunk: int = 512) -> torch.Tensor:
    """Cross-entropy over the vocab projection without the whole (B, S, V)
    logits in f32: each sequence chunk is projected and reduced under
    ``torch.utils.checkpoint``, so its logits are recomputed in the backward
    pass.  x: (B, S, D) final hidden; w_out: (D, V); labels: (B, S).
    Chunked only where the JAX version chunks: S % chunk == 0, S > chunk."""
    B, S, _ = x.shape
    if S % chunk != 0 or S <= chunk:
        return cross_entropy_loss(x @ w_out, labels)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, S, chunk):
        total = total + checkpoint(_chunk_loss, x[:, c:c + chunk], w_out,
                                   labels[:, c:c + chunk], use_reentrant=False)
    return total / (B * S)
