"""Dense decoder-only transformer (qwen3 / phi4 / qwen2 / lidc-demo), ported
from ``repro/models/transformer.py``: init, the training loss (with the
reference's remat policies), prefill, decode.

The JAX version stacks the layers along a leading dim and scans; here each
layer is its own ``Block`` in an ``nn.ModuleList`` and a Python loop runs
them.  ``repro_torch.interop`` moves weights between the two layouts.  The
MoE family reuses the skeleton with its own block and feed-forward
(``models/moe.py``).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import resolve_device
from ..configs.base import ArchConfig
from ..kernels import ops
from . import layers as L
from .sharding import current_rules, shard
from .sharding import zeros as sharded_zeros

__all__ = ["Block", "Transformer", "Model", "init", "init_cache", "block_fwd", "hidden",
           "apply", "logits_of", "lm_loss", "loss_fn", "prefill", "decode_step",
           "REMAT_POLICIES"]

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
    """The parameters of one decoder (dense blocks unless ``block`` says
    otherwise); the functions below run it."""

    def __init__(self, cfg: ArchConfig, *, device=None, dtype=torch.float32,
                 block: type = Block):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.embed = L.Embed(cfg.vocab, cfg.d_model, **kw)
        self.blocks = nn.ModuleList(block(cfg, **kw) for _ in range(cfg.n_layers))
        self.final_norm = L.RMSNorm(cfg.d_model, **kw)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Module()
            self.lm_head.w = L._param((cfg.d_model, cfg.vocab), device, dtype)


Model = Transformer


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init(cfg: ArchConfig, seed: int = 0, *, device=None) -> Transformer:
    """Random weights from a ``torch.Generator`` seeded with ``seed``, drawn
    on ``device`` in the config's dtype (``layers.init_weights_``)."""
    device = resolve_device(device)
    return L.init_weights_(Transformer(cfg, device=device, dtype=dtype_of(cfg)), seed,
                           device)


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


def _mlp(cfg: ArchConfig, blk: Block, h: torch.Tensor) -> torch.Tensor:
    return L.mlp_block(blk.mlp, h)


# the feed-forward half of a block: (cfg, block, normed x) -> residual update
Ffn = Callable[[ArchConfig, nn.Module, torch.Tensor], torch.Tensor]


def block_fwd(cfg: ArchConfig, blk: nn.Module, x: torch.Tensor, ffn: Ffn = _mlp
              ) -> torch.Tensor:
    """One pre-norm block: causal self-attention, then the feed-forward."""
    h = L.rms_norm(blk.norm1.w, x, cfg.norm_eps)
    x = x + L.attention_block(blk.attn, h, n_heads=cfg.n_heads,
                              n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
                              theta=cfg.rope_theta, eps=cfg.norm_eps)
    return shard(x + ffn(cfg, blk, L.rms_norm(blk.norm2.w, x, cfg.norm_eps)),
                 "batch", None, None)


REMAT_POLICIES = ("none", "full", "dots")


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Keep the products with no batch dims (``x @ w``, which reaches the
    dispatcher as ``mm``), recompute everything else, attention included:
    the reference's ``checkpoint_dots_with_no_batch_dims``."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn: Callable, remat: str) -> Callable:
    """``fn`` as the reference's ``_remat_wrap`` runs it: as is ("none"),
    recomputed whole in the backward pass ("full"), or keeping only the
    matrix products' outputs ("dots")."""
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"unknown remat policy {remat!r}; the port has {REMAT_POLICIES}")


def hidden(cfg: ArchConfig, params: Transformer, tokens: torch.Tensor, *,
           remat: str = "none") -> torch.Tensor:
    """Embedding and every block: tokens (B, S) -> hidden (B, S, D).  Runs
    under autograd unless the caller turns it off."""
    x = shard(L.embed_lookup(params.embed, tokens), "batch", None, None)
    body = _remat_wrap(functools.partial(block_fwd, cfg), remat)
    for blk in params.blocks:
        x = body(blk, x)
    return x


@torch.no_grad()
def apply(cfg: ArchConfig, params: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """Full forward: tokens (B, S) -> logits (B, S, V)."""
    return logits_of(cfg, params, hidden(cfg, params, tokens))


def lm_loss(cfg: ArchConfig, params: Transformer, x: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Final norm and the chunked cross-entropy (never the whole (B,S,V)
    logits in f32)."""
    x = L.rms_norm(params.final_norm.w, x, cfg.norm_eps)
    return L.chunked_lm_loss(x, _out_proj(cfg, params), labels)


def loss_fn(cfg: ArchConfig, params: Transformer, batch: Dict[str, torch.Tensor], *,
            remat: str = "none") -> torch.Tensor:
    """Mean next-token loss of ``batch`` ({"tokens", "labels"}, (B, S))."""
    x = hidden(cfg, params, batch["tokens"], remat=remat)
    return lm_loss(cfg, params, x, batch["labels"])


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill(cfg: ArchConfig, params: Transformer, tokens: torch.Tensor,
            max_seq: Optional[int] = None, *, ffn: Ffn = _mlp
            ) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt: last-position logits (B, 1, V) and a cache padded
    with zeros to ``max_seq`` positions."""
    B, S = tokens.shape
    max_seq = max_seq or S
    if S > max_seq:
        raise ValueError(f"prompt of {S} tokens exceeds max_seq={max_seq}")
    shape = (cfg.n_layers, B, max_seq, cfg.n_kv_heads, cfg.hd)
    x = shard(L.embed_lookup(params.embed, tokens), "batch", None, None)
    ks, vs = (sharded_zeros(shape, (None, "batch", None, "tp", None), x) for _ in range(2))
    for i, blk in enumerate(params.blocks):
        hn = L.rms_norm(blk.norm1.w, x, cfg.norm_eps)
        q, k, v = L._project_qkv(blk.attn, hn, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                 cfg.rope_theta, cfg.norm_eps)
        o = ops.attention(q, k, v, causal=True)
        x = x + L._attn_out(o, blk.attn.wo)
        x = shard(x + ffn(cfg, blk, L.rms_norm(blk.norm2.w, x, cfg.norm_eps)),
                  "batch", None, None)
        ks[i, :, :S] = k
        vs[i, :, :S] = v
    cache = {"k": ks, "v": vs,
             "index": torch.tensor(S, dtype=torch.int32, device=x.device)}
    return logits_of(cfg, params, x[:, -1:]), cache


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: Transformer, cache: Cache,
                tokens: torch.Tensor, *, ffn: Ffn = _mlp) -> Tuple[torch.Tensor, Cache]:
    """One decode step: tokens (B, 1) -> logits (B, 1, V) and the cache,
    whose K/V tensors are updated in place and whose index advances."""
    index = cache["index"]
    x = L.embed_lookup(params.embed, tokens)
    # ZeRO-sharded decode activations where the weights are (the reference's
    # zero_decode): resharding a (B,1,D) activation is ~free next to a gather
    zero_decode = bool(current_rules().get("fsdp"))
    for i, blk in enumerate(params.blocks):
        if zero_decode:
            x = shard(x, None, None, "fsdp")
        hn = L.rms_norm(blk.norm1.w, x, cfg.norm_eps)
        x = x + L.attention_decode(blk.attn, hn, cache["k"][i], cache["v"][i], index,
                                   n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                                   head_dim=cfg.hd, theta=cfg.rope_theta,
                                   eps=cfg.norm_eps)
        hn = L.rms_norm(blk.norm2.w, x, cfg.norm_eps)
        if zero_decode:
            hn = shard(hn, None, None, "fsdp")
        x = x + ffn(cfg, blk, hn)
    logits = logits_of(cfg, params, x)
    return logits, {"k": cache["k"], "v": cache["v"], "index": index + 1}
