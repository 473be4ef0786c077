"""Dense decoder-only transformer (qwen3 / phi4 / qwen2 / lidc-demo), ported
from ``repro/models/transformer.py`` for serving: init, prefill, decode.

The JAX version stacks the layers along a leading dim and scans; here each
layer is its own ``Block`` in an ``nn.ModuleList`` and a Python loop runs
them.  ``repro_torch.interop`` moves weights between the two layouts.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from .. import resolve_device
from ..configs.base import ArchConfig
from ..kernels import ops
from . import layers as L

__all__ = ["Block", "Transformer", "init", "init_cache", "apply", "logits_of",
           "prefill", "decode_step"]

Cache = Dict[str, torch.Tensor]


class Block(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = L.RMSNorm(cfg.d_model, **kw)
        self.attn = L.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm, **kw)
        self.norm2 = L.RMSNorm(cfg.d_model, **kw)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, **kw)


class Transformer(nn.Module):
    """The parameters of one dense model; the functions below run it."""

    def __init__(self, cfg: ArchConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.embed = L.Embed(cfg.vocab, cfg.d_model, **kw)
        self.blocks = nn.ModuleList(Block(cfg, **kw) for _ in range(cfg.n_layers))
        self.final_norm = L.RMSNorm(cfg.d_model, **kw)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Module()
            self.lm_head.w = L._param((cfg.d_model, cfg.vocab), device, dtype)


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

@torch.no_grad()
def init(cfg: ArchConfig, seed: int = 0, *, device=None) -> Transformer:
    """Random weights from a ``torch.Generator`` seeded with ``seed``, drawn
    as the JAX init draws them: normal / sqrt(d_in) for projections, normal
    * 0.02 for the embedding, ones for norms, zeros for biases.  (The two
    frameworks' generators differ: for equal weights, use ``interop``.)"""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = Transformer(cfg, device=device, dtype=dtype_of(cfg))
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "w" and p.dim() == 1 or leaf in ("q_norm", "k_norm"):
            p.fill_(1.0)
        elif leaf in ("bq", "bk", "bv"):
            p.zero_()
        else:
            std = 0.02 if leaf == "table" else 1.0 / math.sqrt(p.shape[0])
            for row in range(0, p.shape[0], 4096):   # bounded f32 scratch
                chunk = p[row:row + 4096]
                chunk.copy_(torch.randn(chunk.shape, generator=gen, device=device) * std)
    return model


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype=None, *,
               device=None) -> Cache:
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    dtype = dtype or dtype_of(cfg)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "index": torch.zeros((), dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _out_proj(cfg: ArchConfig, params: Transformer) -> torch.Tensor:
    return params.embed.table.T if cfg.tie_embeddings else params.lm_head.w


def logits_of(cfg: ArchConfig, params: Transformer, x: torch.Tensor) -> torch.Tensor:
    return L.rms_norm(params.final_norm.w, x, cfg.norm_eps) @ _out_proj(cfg, params)


@torch.no_grad()
def apply(cfg: ArchConfig, params: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """Full forward: tokens (B, S) -> logits (B, S, V)."""
    x = L.embed_lookup(params.embed, tokens)
    for blk in params.blocks:
        h = L.rms_norm(blk.norm1.w, x, cfg.norm_eps)
        x = x + L.attention_block(blk.attn, h, n_heads=cfg.n_heads,
                                  n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
                                  theta=cfg.rope_theta, eps=cfg.norm_eps)
        h = L.rms_norm(blk.norm2.w, x, cfg.norm_eps)
        x = x + L.mlp_block(blk.mlp, h)
    return logits_of(cfg, params, x)


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill(cfg: ArchConfig, params: Transformer, tokens: torch.Tensor,
            max_seq: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt: last-position logits (B, 1, V) and a cache padded
    with zeros to ``max_seq`` positions."""
    B, S = tokens.shape
    max_seq = max_seq or S
    if S > max_seq:
        raise ValueError(f"prompt of {S} tokens exceeds max_seq={max_seq}")
    shape = (cfg.n_layers, B, max_seq, cfg.n_kv_heads, cfg.hd)
    x = L.embed_lookup(params.embed, tokens)
    ks = torch.zeros(shape, dtype=x.dtype, device=x.device)
    vs = torch.zeros(shape, dtype=x.dtype, device=x.device)
    for i, blk in enumerate(params.blocks):
        hn = L.rms_norm(blk.norm1.w, x, cfg.norm_eps)
        q, k, v = L._project_qkv(blk.attn, hn, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                 cfg.rope_theta, cfg.norm_eps)
        o = ops.attention(q, k, v, causal=True)
        x = x + o.reshape(B, S, cfg.n_heads * cfg.hd) @ blk.attn.wo
        hn = L.rms_norm(blk.norm2.w, x, cfg.norm_eps)
        x = x + L.mlp_block(blk.mlp, hn)
        ks[i, :, :S] = k
        vs[i, :, :S] = v
    cache = {"k": ks, "v": vs,
             "index": torch.tensor(S, dtype=torch.int32, device=x.device)}
    return logits_of(cfg, params, x[:, -1:]), cache


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: Transformer, cache: Cache,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """One decode step: tokens (B, 1) -> logits (B, 1, V) and the cache,
    whose K/V tensors are updated in place and whose index advances."""
    index = cache["index"]
    x = L.embed_lookup(params.embed, tokens)
    for i, blk in enumerate(params.blocks):
        hn = L.rms_norm(blk.norm1.w, x, cfg.norm_eps)
        x = x + L.attention_decode(blk.attn, hn, cache["k"][i], cache["v"][i], index,
                                   n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                                   head_dim=cfg.hd, theta=cfg.rope_theta,
                                   eps=cfg.norm_eps)
        hn = L.rms_norm(blk.norm2.w, x, cfg.norm_eps)
        x = x + L.mlp_block(blk.mlp, hn)
    logits = logits_of(cfg, params, x)
    return logits, {"k": cache["k"], "v": cache["v"], "index": index + 1}


def param_shapes(cfg: ArchConfig) -> Dict[str, Any]:
    """Parameter name -> shape, allocating nothing (meta device)."""
    model = Transformer(cfg, device="meta")
    return {name: tuple(p.shape) for name, p in model.named_parameters()}
