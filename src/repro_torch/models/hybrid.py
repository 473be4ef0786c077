"""Zamba2-style hybrid: Mamba2 backbone plus one *shared* attention block,
ported from ``repro/models/hybrid.py``.

The shared transformer block (attention + MLP, one set of weights) follows
every ``attn_every`` Mamba2 blocks; its input is the current hidden state
concatenated with the original embedding, through a per-application
projection.  The layers are modules: ``mamba[s][j]`` is the j-th Mamba2
block of super-block s (the reference stacks them ``(n_super, attn_every,
...)``), ``proj_in[s]`` / ``proj_out[s]`` the adapters of application s.
Attention runs through ``ops.attention`` (prefill) and
``ops.decode_attention`` (decode, one scalar cache index), the SSD state
scan through ``ops.ssd_state_scan``.  ``loss_fn`` trains through
``hidden``, each super-block under the reference's remat policies;
``apply`` and the serve steps run without autograd.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .. import resolve_device
from ..configs.base import ArchConfig
from ..kernels import ops
from . import layers as L
from . import mamba2 as M
from . import transformer as T
from .sharding import batch_laid_out, shard

__all__ = ["Hybrid", "Model", "n_super", "init", "init_cache", "hidden",
           "apply", "loss_fn", "prefill", "decode_step"]

Cache = T.Cache


def n_super(cfg: ArchConfig) -> int:
    if cfg.n_layers % cfg.attn_every:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                         f"attn_every {cfg.attn_every}")
    return cfg.n_layers // cfg.attn_every


class _Proj(nn.Module):
    def __init__(self, d_in: int, d_out: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.w = L._param((d_in, d_out), device, dtype)


class Hybrid(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        D, S = cfg.d_model, n_super(cfg)
        self.embed = L.Embed(cfg.vocab, D, **kw)
        self.mamba = nn.ModuleList(
            nn.ModuleList(M.SSMBlock(cfg, **kw) for _ in range(cfg.attn_every))
            for _ in range(S))
        self.shared = T.Block(cfg, **kw)
        self.proj_in = nn.ModuleList(_Proj(2 * D, D, **kw) for _ in range(S))
        self.proj_out = nn.ModuleList(_Proj(D, D, **kw) for _ in range(S))
        self.final_norm = L.RMSNorm(D, **kw)
        self.lm_head = _Proj(D, cfg.vocab, **kw)


Model = Hybrid


def init(cfg: ArchConfig, seed: int = 0, *, device=None) -> Hybrid:
    """Random weights from a seeded ``torch.Generator``, drawn on ``device``
    in the config's dtype (``layers.init_weights_``)."""
    device = resolve_device(device)
    return L.init_weights_(Hybrid(cfg, device=device, dtype=T.dtype_of(cfg)), seed, device)


def _shared_attn(cfg: ArchConfig, params: Hybrid, s: int, x: torch.Tensor,
                 x0: torch.Tensor) -> torch.Tensor:
    h = torch.cat([x, x0], dim=-1) @ params.proj_in[s].w
    return x + T.block_fwd(cfg, params.shared, h) @ params.proj_out[s].w


def _super_block(cfg: ArchConfig, params: Hybrid, s: int, x: torch.Tensor,
                 x0: torch.Tensor) -> torch.Tensor:
    """Super-block ``s``: its ``attn_every`` Mamba2 blocks, then the shared
    block's application ``s``."""
    for blk in params.mamba[s]:
        x = M.ssm_block_apply(cfg, blk, x)
    return shard(_shared_attn(cfg, params, s, x, x0), "batch", None, None)


def hidden(cfg: ArchConfig, params: Hybrid, tokens: torch.Tensor, *,
           remat: str = "none") -> torch.Tensor:
    """Embedding and every super-block: tokens (B, S) -> hidden (B, S, D).
    Each super-block runs under the remat policy, as the reference's scan
    body does; under autograd unless the caller turns it off."""
    x0 = shard(L.embed_lookup(params.embed, tokens), "batch", None, None)
    body = T._remat_wrap(functools.partial(_super_block, cfg, params), remat)
    x = x0
    for s in range(n_super(cfg)):
        x = body(s, x, x0)
    return x


@torch.no_grad()
def apply(cfg: ArchConfig, params: Hybrid, tokens: torch.Tensor) -> torch.Tensor:
    return T.logits_of(cfg, params, hidden(cfg, params, tokens))


def loss_fn(cfg: ArchConfig, params: Hybrid, batch: Dict[str, torch.Tensor], *,
            remat: str = "none") -> torch.Tensor:
    """Mean next-token loss of ``batch`` ({"tokens", "labels"}, (B, S))."""
    x = hidden(cfg, params, batch["tokens"], remat=remat)
    return T.lm_loss(cfg, params, x, batch["labels"])


# ---------------------------------------------------------------------------
# serving: the SSM state is O(1); the shared block's KV cache is the only
# sequence-length state
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype: Optional[torch.dtype] = None, *, device=None) -> Cache:
    device = resolve_device(device)
    dtype = dtype or T.dtype_of(cfg)
    kv = (n_super(cfg), batch, max_seq, cfg.n_kv_heads, cfg.hd)
    cache = M.init_ssm_cache(cfg, cfg.n_layers, batch, dtype, device=device)
    cache["k"] = torch.zeros(kv, dtype=dtype, device=device)
    cache["v"] = torch.zeros(kv, dtype=dtype, device=device)
    cache["index"] = torch.zeros((), dtype=torch.int32, device=device)
    return cache


def _ssm_apply_with_state(cfg: ArchConfig, blk: M.SSMBlock, x: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``ssm_block_apply`` that also returns the final SSD state and the
    conv cache: the last K-1 inputs *before* the convolution."""
    out, final, xbc = M.ssm_block_core(cfg, blk, x)
    return out, final, xbc[:, -(cfg.conv_kernel - 1):]


@torch.no_grad()
def prefill(cfg: ArchConfig, params: Hybrid, tokens: torch.Tensor,
            max_seq: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt, unrolled over the super-blocks: last-position logits
    (B, 1, V) and the cache (final SSD states, conv inputs, the shared
    block's K/V padded with zeros to ``max_seq``).  A prompt shorter than
    K-1 leaves the conv cache's leading positions at zero, the convolution's
    own padding (the reference's cache then has the wrong length)."""
    B, S = tokens.shape
    max_seq = max_seq or S
    if S > max_seq:
        raise ValueError(f"prompt of {S} tokens exceeds max_seq={max_seq}")
    x0 = shard(L.embed_lookup(params.embed, tokens), "batch", None, None)
    x = x0
    cache = batch_laid_out(init_cache(cfg, B, max_seq, device=x.device), x)
    sh = params.shared
    for s, group in enumerate(params.mamba):
        for j, blk in enumerate(group):
            i = s * cfg.attn_every + j
            x, cache["state"][i], conv = _ssm_apply_with_state(cfg, blk, x)
            cache["conv"][i, :, cache["conv"].shape[2] - conv.shape[1]:] = conv
        h = torch.cat([x, x0], dim=-1) @ params.proj_in[s].w
        hn = L.rms_norm(sh.norm1.w, h, cfg.norm_eps)
        q, k, v = L._project_qkv(sh.attn, hn, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                 cfg.rope_theta, cfg.norm_eps)
        o = ops.attention(q, k, v, causal=True)
        h = h + L._attn_out(o, sh.attn.wo)
        h = h + L.mlp_block(sh.mlp, L.rms_norm(sh.norm2.w, h, cfg.norm_eps))
        x = shard(x + h @ params.proj_out[s].w, "batch", None, None)
        cache["k"][s, :, :S] = k
        cache["v"][s, :, :S] = v
    cache["index"] = torch.tensor(S, dtype=torch.int32, device=x.device)
    return T.logits_of(cfg, params, x[:, -1:]), cache


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: Hybrid, cache: Cache, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Cache]:
    """One decode step: tokens (B, 1) -> logits (B, 1, V) and the cache,
    whose tensors are updated IN PLACE (SSD states, conv windows, the new
    K/V at ``index``) and whose index advances."""
    index = cache["index"]
    x0 = L.embed_lookup(params.embed, tokens)
    x = x0
    sh = params.shared
    for s, group in enumerate(params.mamba):
        for j, blk in enumerate(group):
            i = s * cfg.attn_every + j
            x, cache["state"][i], cache["conv"][i] = M.ssm_decode_step(
                cfg, blk, x, cache["state"][i], cache["conv"][i])
        h = torch.cat([x, x0], dim=-1) @ params.proj_in[s].w
        hn = L.rms_norm(sh.norm1.w, h, cfg.norm_eps)
        h = h + L.attention_decode(sh.attn, hn, cache["k"][s], cache["v"][s], index,
                                   n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                                   head_dim=cfg.hd, theta=cfg.rope_theta,
                                   eps=cfg.norm_eps)
        h = h + L.mlp_block(sh.mlp, L.rms_norm(sh.norm2.w, h, cfg.norm_eps))
        x = x + h @ params.proj_out[s].w
    return T.logits_of(cfg, params, x), {**cache, "index": index + 1}
