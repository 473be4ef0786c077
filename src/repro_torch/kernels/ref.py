"""Plain PyTorch versions of the attention kernels.

They compute what ``repro.kernels.ref`` computes (the pure-jnp oracles):
the CPU path of ``ops`` runs them, the tests hold them against the JAX
oracles, and ``chip_smoke.py`` holds the CUDA kernels against them on the
card.  Grouped-query form: the KV heads are never repeated.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["attention_ref", "decode_attention_ref"]

_NEG = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, scale: Optional[float] = None
                  ) -> torch.Tensor:
    """GQA attention.  q: (B,S,H,hd), k/v: (B,T,K,hd) with H % K == 0.

    Queries are the *last* S of the T key positions (offset T-S).  Logits
    and softmax are f32; probabilities are cast to ``v.dtype`` before the
    PV product, as the JAX oracle does.
    """
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else hd ** -0.5
    qg = q.reshape(B, S, K, G, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    if causal:
        qpos = torch.arange(S, device=q.device)[:, None] + (T - S)
        kpos = torch.arange(T, device=q.device)[None, :]
        logits = logits.masked_fill(kpos > qpos, _NEG)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, H, hd)


def decode_attention_ref(q: torch.Tensor, cache_k: torch.Tensor,
                         cache_v: torch.Tensor,
                         length: Union[int, torch.Tensor]) -> torch.Tensor:
    """One-token decode.  q: (B,1,H,hd), cache: (B,Smax,K,hd), length: a
    scalar or per-slot (B,) count of valid positions."""
    B, _, H, hd = q.shape
    Smax, K = cache_k.shape[1], cache_k.shape[2]
    qg = q.reshape(B, K, H // K, hd)
    logits = torch.einsum("bkgd,btkd->bkgt", qg.float(),
                          cache_k.float()) * hd ** -0.5
    length = torch.as_tensor(length, device=q.device).reshape(-1, 1)
    valid = torch.arange(Smax, device=q.device)[None, :] < length  # (B,Smax)
    logits = logits.masked_fill(~valid[:, None, None, :], _NEG)
    probs = torch.softmax(logits, dim=-1).to(cache_v.dtype)
    out = torch.einsum("bkgt,btkd->bkgd", probs, cache_v)
    return out.reshape(B, 1, H, hd)
