"""Plain PyTorch versions of the kernels.

They compute what ``repro.kernels.ref`` computes (the pure-jnp oracles):
the CPU path of ``ops`` runs them, the tests hold them against the JAX
oracles, and ``chip_smoke.py`` holds the CUDA kernels against them on the
card.  Grouped-query form: the KV heads are never repeated.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

__all__ = ["attention_ref", "attention_lse_ref", "attention_bwd_ref",
           "decode_attention_ref", "ssd_state_scan_ref", "ssd_state_scan_bwd_ref",
           "moe_gating_ref", "moe_router_ref", "moe_router_bwd_ref"]

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


def _scaled_scores(q: torch.Tensor, k: torch.Tensor, scale: Optional[float]):
    """(f32 scaled scores (B,K,G,S,T), the causal mask (S,T): True where a
    query must not see a key, and the scale)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    qg = q.float().reshape(B, S, K, H // K, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    qpos = torch.arange(S, device=q.device)[:, None] + (T - S)
    return logits, torch.arange(T, device=q.device)[None, :] > qpos, scale


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                      scale: Optional[float] = None) -> torch.Tensor:
    """The log-sum-exp of each query row's scaled scores over the keys it
    sees, (B,H,S) f32: what the forward kernel saves for its backward."""
    logits, masked, _ = _scaled_scores(q, k, scale)
    if causal:
        logits = logits.masked_fill(masked, _NEG)
    B, S, H, _ = q.shape
    return torch.logsumexp(logits, dim=-1).reshape(B, H, S)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                      lse: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                      scale: Optional[float] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The closed-form gradient of attention, as the backward kernel computes
    it, in f32 from the given inputs: P = exp(scale q k^T - lse) (0 where
    masked), D = rowsum(dO o), dV = P^T dO, dS = P (dO v^T - D),
    dK = scale dS^T q, dQ = scale dS k, summed over each KV head's group.
    o and lse are the forward's (B,S,H,hd) output and (B,H,S) log-sum-exp.
    Returns (dq, dk, dv) in the dtypes of q, k, v."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    logits, masked, scale = _scaled_scores(q, k, scale)
    p = torch.exp(logits - lse.float().reshape(B, K, G, S, 1))
    if causal:
        p = p.masked_fill(masked, 0.0)
    dog = do.float().reshape(B, S, K, G, hd)
    dot = (dog * o.float().reshape(B, S, K, G, hd)).sum(-1)          # (B,S,K,G)
    dp = torch.einsum("bskgd,btkd->bkgst", dog, v.float())
    ds = p * (dp - dot.permute(0, 2, 3, 1)[..., None])
    dv = torch.einsum("bkgst,bskgd->btkd", p, dog)
    dk = torch.einsum("bkgst,bskgd->btkd", ds, q.float().reshape(B, S, K, G, hd)) * scale
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.float()) * scale
    return dq.reshape(B, S, H, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def ssd_state_scan_ref(chunk_states: torch.Tensor, chunk_decays: torch.Tensor,
                       init_state: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 inter-chunk state recurrence.  chunk_states: (B,C,H,P,N),
    chunk_decays: (B,C,H).  Returns (prefix (B,C,H,P,N), the state entering
    each chunk; final (B,H,P,N)), walking c in order:
    ``prefix[c] = s; s = a[c] * s + x[c]``."""
    B, C, H, P, N = chunk_states.shape
    s = (torch.zeros((B, H, P, N), dtype=chunk_states.dtype,
                     device=chunk_states.device)
         if init_state is None else init_state)
    prefix = []
    for c in range(C):
        prefix.append(s)
        s = chunk_decays[:, c, :, None, None] * s + chunk_states[:, c]
    return torch.stack(prefix, dim=1), s


def ssd_state_scan_bwd_ref(g_prefix: Optional[torch.Tensor], g_final: Optional[torch.Tensor],
                           prefix: torch.Tensor, chunk_decays: torch.Tensor, has_init: bool
                           ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The closed-form gradient of ``ssd_state_scan_ref``, as the backward
    kernel computes it, from the gradients of its outputs (either may be
    None: nothing reads that output) and the forward's ``prefix`` (B,C,H,P,N)
    and decays a (B,C,H).  With G the gradient of the state entering chunk
    c+1 (``g_final``, or zeros, past the last chunk), walking c from C-1
    down to 0: ``d_states[c] = G``; ``d_decays[c] = sum_{P,N} G * prefix[c]``;
    then ``G = g_prefix[c] + a[c] * G``.  Returns (d_states, d_decays,
    d_init = the last G, or None without ``has_init``)."""
    B, C, H, P, N = prefix.shape
    G = (torch.zeros((B, H, P, N), dtype=prefix.dtype, device=prefix.device)
         if g_final is None else g_final.to(prefix.dtype))
    d_states, d_decays = torch.empty_like(prefix), prefix.new_empty((B, C, H))
    for c in range(C - 1, -1, -1):
        d_states[:, c] = G
        d_decays[:, c] = (G * prefix[:, c]).sum(dim=(-1, -2))
        G = chunk_decays[:, c, :, None, None] * G
        if g_prefix is not None:
            G = G + g_prefix[:, c]
    return d_states, d_decays, G if has_init else None


def moe_gating_ref(logits: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router: softmax over experts in f32, top-k, renormalised.  logits
    (T,E) -> (weights (T,k) f32, ids (T,k) int32).  Ties go to the lowest
    expert index, as ``lax.top_k`` breaks them: a stable descending sort
    keeps equal values in index order (``torch.topk`` promises no order)."""
    probs = torch.softmax(logits.float(), dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :k], ids[:, :k]
    return w / w.sum(dim=-1, keepdim=True), ids.to(torch.int32)


def moe_router_ref(x: torch.Tensor, router: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router's whole chain, as the reference's ``_local_moe`` runs it:
    logits ``x.float() @ router`` in f32, ``moe_gating_ref`` on them, and
    their softmax for the load-balance statistics.  x (T,D), router (D,E)
    f32 -> (weights (T,k) f32, ids (T,k) int32, probabilities (T,E) f32)."""
    logits = x.float() @ router
    w, ids = moe_gating_ref(logits, k)
    return w, ids, torch.softmax(logits, dim=-1)


def moe_router_bwd_ref(gw: torch.Tensor, gprobs: Optional[torch.Tensor], w: torch.Tensor,
                       ids: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """The closed-form gradient of ``moe_router_ref``'s outputs with respect
    to its logits, as the backward kernel computes it: gw (T,k) and gprobs
    (T,E) (None where nothing reads the probabilities) against the forward's
    weights w (T,k), ids (T,k) and probabilities p (T,E) -> dlogits (T,E)
    in f32 (f64 for f64 probabilities).  With s_j = p[ids_j] and S = sum_j s_j (w_j = s_j / S):
    ds_j = (gw_j - sum_i gw_i w_i) / S; g = gprobs + ds scattered to ids;
    dlogits = p (g - sum_e p_e g_e).  The router's products follow from
    it: dx = dlogits @ router^T in x's dtype, drouter = x.float()^T @
    dlogits."""
    dt = torch.promote_types(probs.dtype, torch.float32)
    p, gw, w = probs.to(dt), gw.to(dt), w.to(dt)
    idx = ids.long()
    s = p.gather(1, idx)
    ds = (gw - (gw * w).sum(dim=1, keepdim=True)) / s.sum(dim=1, keepdim=True)
    g = torch.zeros_like(p) if gprobs is None else gprobs.to(dt, copy=True)
    g.scatter_add_(1, idx, ds)
    return p * (g - (p * g).sum(dim=1, keepdim=True))
