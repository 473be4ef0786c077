"""Encoder-decoder backbone (seamless-m4t-large-v2), ported from
``repro/models/encdec.py``.

The speech frontend is a stub, as in the reference: the model takes
precomputed frame embeddings (B, F, d_model).  The encoder's blocks are the
dense ``transformer.Block`` run without the causal mask; each decoder block
carries causal self-attention (``attn``), cross-attention to the encoder's
output (``xattn``: q from the decoder, K/V projected from the encoder's
output, no RoPE, no mask) and the MLP.  All attention runs through
``ops.attention`` (training, prefill) and ``ops.decode_attention`` (decode:
self-attention at ``index + 1`` positions, cross-attention at the 0-dim
``enc_len``).

Frames come in the config's dtype.  The reference refuses any other: under
JAX's promotion they would change the dtype of its encoder's or decoder's
``lax.scan`` carry, which raises (f32 frames in a bf16 model, as
``SyntheticLM`` makes them, promote the decoder from the first
cross-attention on).  The port refuses them too, with a clearer error, so
that a job means one thing on either framework.
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
from . import transformer as T

__all__ = ["DecBlock", "EncDec", "Model", "init", "encode", "hidden", "apply", "loss_fn",
           "init_cache", "prefill", "decode_step"]

Cache = T.Cache
Inputs = Dict[str, torch.Tensor]     # {"frames": (B, F, D), "tokens": (B, S)}


class DecBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        self.norm1 = L.RMSNorm(D, **kw)
        self.attn = L.Attention(D, H, K, hd, **kw)
        self.norm2 = L.RMSNorm(D, **kw)
        self.xattn = L.Attention(D, H, K, hd, **kw)
        self.norm3 = L.RMSNorm(D, **kw)
        self.mlp = L.MLP(D, cfg.d_ff, **kw)


class EncDec(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.embed = L.Embed(cfg.vocab, cfg.d_model, **kw)
        self.enc_blocks = nn.ModuleList(T.Block(cfg, **kw) for _ in range(cfg.enc_layers))
        self.enc_norm = L.RMSNorm(cfg.d_model, **kw)
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, **kw) for _ in range(cfg.dec_layers))
        self.final_norm = L.RMSNorm(cfg.d_model, **kw)
        self.lm_head = nn.Module()
        self.lm_head.w = L._param((cfg.d_model, cfg.vocab), device, dtype)


Model = EncDec


def init(cfg: ArchConfig, seed: int = 0, *, device=None) -> EncDec:
    """Random weights from a seeded ``torch.Generator``, drawn on ``device``
    in the config's dtype (``layers.init_weights_``)."""
    device = resolve_device(device)
    return L.init_weights_(EncDec(cfg, device=device, dtype=T.dtype_of(cfg)), seed, device)


def _attn(cfg: ArchConfig, p: L.Attention, x: torch.Tensor, **kw) -> torch.Tensor:
    return L.attention_block(p, x, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                             head_dim=cfg.hd, eps=cfg.norm_eps, **kw)


def _enc_block_fwd(cfg: ArchConfig, blk: T.Block, x: torch.Tensor) -> torch.Tensor:
    """One encoder block: bidirectional self-attention, then the MLP."""
    x = x + _attn(cfg, blk.attn, L.rms_norm(blk.norm1.w, x, cfg.norm_eps),
                  theta=cfg.rope_theta, causal=False)
    return x + L.mlp_block(blk.mlp, L.rms_norm(blk.norm2.w, x, cfg.norm_eps))


def encode(cfg: ArchConfig, params: EncDec, frames: torch.Tensor, *,
           remat: str = "none") -> torch.Tensor:
    """frames (B, F, D), the frontend's stub embeddings in the model's
    dtype -> the encoder's normed output (B, F, D).  Frames of another dtype
    raise ``TypeError``, as the reference's ``hidden`` and ``prefill`` do."""
    dtype = params.embed.table.dtype
    if frames.dtype != dtype:
        raise TypeError(f"frames of {frames.dtype} in an encoder-decoder of {dtype}: the "
                        f"reference refuses them (its scan carry would change dtype); "
                        f"give frames in the config's dtype")
    body = T._remat_wrap(functools.partial(_enc_block_fwd, cfg), remat)
    x = frames
    for blk in params.enc_blocks:
        x = body(blk, x)
    return L.rms_norm(params.enc_norm.w, x, cfg.norm_eps)


def _enc_kv(cfg: ArchConfig, blk: DecBlock, enc_out: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A decoder block's cross-attention K/V, (B, F, K, hd) each."""
    B, F, _ = enc_out.shape
    k = (enc_out @ blk.xattn.wk).reshape(B, F, cfg.n_kv_heads, cfg.hd)
    v = (enc_out @ blk.xattn.wv).reshape(B, F, cfg.n_kv_heads, cfg.hd)
    return k, v


def _cross_and_mlp(cfg: ArchConfig, blk: DecBlock, x: torch.Tensor,
                   enc_kv: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    x = x + _attn(cfg, blk.xattn, L.rms_norm(blk.norm2.w, x, cfg.norm_eps), theta=0.0,
                  kv_override=enc_kv)
    return x + L.mlp_block(blk.mlp, L.rms_norm(blk.norm3.w, x, cfg.norm_eps))


def _dec_block_fwd(cfg: ArchConfig, blk: DecBlock, x: torch.Tensor,
                   enc_out: torch.Tensor) -> torch.Tensor:
    """One decoder block: causal self-attention, cross-attention, MLP."""
    x = x + _attn(cfg, blk.attn, L.rms_norm(blk.norm1.w, x, cfg.norm_eps),
                  theta=cfg.rope_theta)
    return _cross_and_mlp(cfg, blk, x, _enc_kv(cfg, blk, enc_out))


def hidden(cfg: ArchConfig, params: EncDec, batch_inputs: Inputs, *,
           remat: str = "none") -> torch.Tensor:
    """The encoder over the frames, then the decoder over the tokens: hidden
    (B, S, D).  Each block runs under the remat policy, as the reference's
    scan bodies do (a decoder block's cross K/V inside it); under autograd
    unless the caller turns it off."""
    enc_out = encode(cfg, params, batch_inputs["frames"], remat=remat)
    x = L.embed_lookup(params.embed, batch_inputs["tokens"])
    body = T._remat_wrap(functools.partial(_dec_block_fwd, cfg), remat)
    for blk in params.dec_blocks:
        x = body(blk, x, enc_out)
    return x


@torch.no_grad()
def apply(cfg: ArchConfig, params: EncDec, batch_inputs: Inputs) -> torch.Tensor:
    return T.logits_of(cfg, params, hidden(cfg, params, batch_inputs))


def loss_fn(cfg: ArchConfig, params: EncDec, batch: Dict[str, torch.Tensor], *,
            remat: str = "none") -> torch.Tensor:
    """Mean next-token loss of ``batch`` ({"frames", "tokens", "labels"})."""
    x = hidden(cfg, params, batch, remat=remat)
    return T.lm_loss(cfg, params, x, batch["labels"])


# ---------------------------------------------------------------------------
# serving: the decoder's self-attention KV and the encoder's cross K/V
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_seq: int, enc_len: int = 0,
               dtype: Optional[torch.dtype] = None, *, device=None) -> Cache:
    """Zeroed self-attention K/V (L_dec, B, max_seq, K, hd), cross K/V
    (L_dec, B, enc_len, K, hd) (``enc_len`` defaults to ``max_seq``), the
    0-dim ``enc_len`` and ``index``."""
    device = resolve_device(device)
    dtype = dtype or T.dtype_of(cfg)
    enc_len = enc_len or max_seq
    heads = (cfg.n_kv_heads, cfg.hd)

    def zeros(n):
        return torch.zeros((cfg.dec_layers, batch, n, *heads), dtype=dtype, device=device)

    return {"k": zeros(max_seq), "v": zeros(max_seq), "xk": zeros(enc_len),
            "xv": zeros(enc_len),
            "enc_len": torch.tensor(enc_len, dtype=torch.int32, device=device),
            "index": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def prefill(cfg: ArchConfig, params: EncDec, batch_inputs: Inputs,
            max_seq: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    """Encode the frames, project every decoder block's cross K/V, and run
    the decoder over the prompt tokens (one BOS each, typically): last-
    position logits (B, 1, V) and the cache, self-attention K/V padded with
    zeros to ``max_seq``."""
    tokens = batch_inputs["tokens"]
    B, S = tokens.shape
    max_seq = max_seq or S
    if S > max_seq:
        raise ValueError(f"prompt of {S} tokens exceeds max_seq={max_seq}")
    enc_out = encode(cfg, params, batch_inputs["frames"])
    x = L.embed_lookup(params.embed, tokens)
    xks, xvs, ks, vs = [], [], [], []
    for blk in params.dec_blocks:
        hn = L.rms_norm(blk.norm1.w, x, cfg.norm_eps)
        q, k, v = L._project_qkv(blk.attn, hn, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                 cfg.rope_theta, cfg.norm_eps)
        o = ops.attention(q, k, v, causal=True)
        x = x + o.reshape(B, S, cfg.n_heads * cfg.hd) @ blk.attn.wo
        xk, xv = _enc_kv(cfg, blk, enc_out)
        x = _cross_and_mlp(cfg, blk, x, (xk, xv))
        ks.append(k)
        vs.append(v)
        xks.append(xk)
        xvs.append(xv)
    kv = torch.zeros((cfg.dec_layers, B, max_seq, cfg.n_kv_heads, cfg.hd), dtype=x.dtype,
                     device=x.device)
    cache = {"k": kv, "v": kv.clone(), "xk": torch.stack(xks), "xv": torch.stack(xvs),
             "enc_len": torch.tensor(enc_out.shape[1], dtype=torch.int32, device=x.device),
             "index": torch.tensor(S, dtype=torch.int32, device=x.device)}
    for i, (k, v) in enumerate(zip(ks, vs)):
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    return T.logits_of(cfg, params, x[:, -1:]), cache


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: EncDec, cache: Cache, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Cache]:
    """One decode step: tokens (B, 1) -> logits (B, 1, V) and the cache,
    whose self-attention K/V are written IN PLACE at ``index`` and whose
    index advances.  Cross-attention projects q with ``wq`` alone and
    attends over ``enc_len`` positions of the cross K/V."""
    B = tokens.shape[0]
    H, hd = cfg.n_heads, cfg.hd
    index = cache["index"]
    x = L.embed_lookup(params.embed, tokens)
    for i, blk in enumerate(params.dec_blocks):
        hn = L.rms_norm(blk.norm1.w, x, cfg.norm_eps)
        x = x + L.attention_decode(blk.attn, hn, cache["k"][i], cache["v"][i], index,
                                   n_heads=H, n_kv=cfg.n_kv_heads, head_dim=hd,
                                   theta=cfg.rope_theta, eps=cfg.norm_eps)
        hn = L.rms_norm(blk.norm2.w, x, cfg.norm_eps)
        xk, xv = cache["xk"][i], cache["xv"][i]
        q = (hn @ blk.xattn.wq).reshape(B, 1, H, hd)
        o = ops.decode_attention(q, xk, xv, cache["enc_len"])
        x = x + o.reshape(B, 1, H * hd) @ blk.xattn.wo
        x = x + L.mlp_block(blk.mlp, L.rms_norm(blk.norm3.w, x, cfg.norm_eps))
    return T.logits_of(cfg, params, x), {**cache, "index": index + 1}
