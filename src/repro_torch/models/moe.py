"""Mixture-of-Experts transformer (qwen3-moe-30b-a3b, grok-1-314b), ported
from ``repro/models/moe.py``: init, the training loss with its Switch
load-balance term (the reference's remat policies), prefill, decode, on one
device.

Dispatch is the reference's sort-based capacity dispatch (``_local_moe``):
tokens are routed by ``ops.moe_router`` (on the card one CUDA kernel for
the router product, softmax and top-k, whose gradient is the
``moe_router_bwd`` kernel), sorted by expert, scattered into an
``(E, cap, D)`` buffer and multiplied by every expert in three batched
matrix products; assignments past an expert's capacity are dropped.  The
layers reuse the dense skeleton of ``transformer.py`` with a ``Block`` whose
feed-forward is the MoE.

Under a mesh whose ``tp`` axis is larger than 1 (``sharding.use_mesh``,
rules with ``expert`` or ``tp_ff``), ``moe_block`` is the reference's
``shard_map`` branch: activations are replicated over ``model`` and
sharded over the batch axes, every ``model`` rank routes all of its data
shard's tokens and keeps either the assignments that fall in its slice of
the experts (expert parallel, ``E % tp == 0``) or all experts on its slice
of ``d_ff`` (expert TP), and one ``psum`` over ``model`` combines the
ranks.  ``local_experts`` cuts a rank's shard of the weights.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..collectives import axis_groups, axis_index, pmean, psum, pvary
from ..configs.base import ArchConfig
from ..kernels import ops
from . import layers as L
from . import transformer as T
from .sharding import _mesh_axes, _resolve, current_rules

__all__ = ["MoE", "Block", "Model", "init_moe", "init", "init_cache",
           "moe_block", "local_experts", "hidden", "apply", "AUX_LOSS_COEF", "loss_fn",
           "prefill", "decode_step"]

init_cache = T.init_cache


class MoE(nn.Module):
    """Router (D,E) in f32; experts ``w_gate``/``w_up`` (E,D,F) and
    ``w_down`` (E,F,D) in the model's dtype."""

    def __init__(self, cfg: ArchConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        E, D, F_ = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.router = L._param((D, E), device, torch.float32)
        self.w_gate = L._param((E, D, F_), device, dtype)
        self.w_up = L._param((E, D, F_), device, dtype)
        self.w_down = L._param((E, F_, D), device, dtype)


class Block(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = L.RMSNorm(cfg.d_model, **kw)
        self.attn = L.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm, **kw)
        self.norm2 = L.RMSNorm(cfg.d_model, **kw)
        self.moe = MoE(cfg, **kw)


def Model(cfg: ArchConfig, *, device=None, dtype=torch.float32) -> T.Transformer:
    return T.Transformer(cfg, device=device, dtype=dtype, block=Block)


def init_moe(cfg: ArchConfig, seed: int = 0, *, device=None) -> MoE:
    """One MoE layer's weights, drawn as ``init`` draws them."""
    device = resolve_device(device)
    return L.init_weights_(MoE(cfg, device=device, dtype=T.dtype_of(cfg)), seed, device)


def init(cfg: ArchConfig, seed: int = 0, *, device=None) -> T.Transformer:
    """Random weights from a seeded ``torch.Generator``, drawn on ``device``
    in the config's dtype one parameter at a time: nothing of the model
    passes through the host or exists in f32 beyond one parameter's
    scratch."""
    device = resolve_device(device)
    return L.init_weights_(Model(cfg, device=device, dtype=T.dtype_of(cfg)), seed, device)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def _local_moe(cfg: ArchConfig, xf: torch.Tensor, p: MoE, e_lo: int = 0,
               E_loc: Optional[int] = None, over_data: Callable = _same,
               over_model: Callable = _same
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Sort-based dispatch of the tokens xf (T, D) into the experts
    [e_lo, e_lo + E_loc) whose weights ``p`` holds.  Returns (the experts'
    output (T, D), the Switch statistics (f_e, P_e) of the slice).

    As in the reference: each assignment's position within its expert is
    computed before the sort (a cumulative sum of one-hot rows in
    token-major order), so the stably sorted stream is cut to its first
    ``n_sel`` entries; assignments at or past ``cap`` are dropped and
    contribute zero.  Every expert is multiplied, routed to or not.

    ``over_data`` and ``over_model`` (``collectives.pvary`` over those
    axes in the sharded branch) mark where a replicated value meets one
    that varies over the batch axes or over ``model``: the weights meet
    this shard's tokens, and the tokens, their routing weights and (for a
    slice of the experts) the mean probabilities meet this rank's experts.
    """
    T_, D = xf.shape
    E, k = cfg.n_experts, cfg.top_k
    E_loc = E if E_loc is None else E_loc
    Tk = T_ * k
    cap = int(cfg.capacity_factor * Tk / E)
    cap = max(8, (cap + 7) // 8 * 8)
    n_sel = min(E_loc * cap, Tk)

    # the f32 logits xf.float() @ router, their top-k and their softmax, in
    # one call: (T,k), (T,k), (T,E)
    weights, ids, probs = ops.moe_router(xf, over_data(p.router), k)

    # counts by scatter-add (exact in f32), not bincount, which waits for
    # the device to size its output
    frac_disp = torch.zeros(E, dtype=torch.float32, device=xf.device).index_add_(
        0, ids.reshape(-1), torch.ones(Tk, dtype=torch.float32, device=xf.device)) / Tk
    mean_prob = probs.mean(dim=0)
    if E_loc < E:
        mean_prob = over_model(mean_prob)
    aux_stats = (frac_disp[e_lo:e_lo + E_loc], mean_prob[e_lo:e_lo + E_loc])

    flat_ids = ids.reshape(Tk).long() - e_lo                   # local coords
    in_range = (flat_ids >= 0) & (flat_ids < E_loc)
    lid = torch.where(in_range, flat_ids, E_loc)
    oh = F.one_hot(lid, E_loc + 1)                             # (Tk, E+1)
    pos = torch.cumsum(oh, dim=0).gather(1, lid[:, None])[:, 0] - 1
    key = torch.where(in_range & (pos < cap), lid, E_loc)
    order = torch.argsort(key, stable=True)[:n_sel]
    sel_ids = key[order]
    sel_pos = pos[order]
    sel_tok = order // k
    keep = sel_ids < E_loc

    # The reference writes with mode="drop" at index cap for dropped
    # assignments; here they go to one spare row past the buffer, which is
    # never read, so the write needs no bounds check and no host sync.
    slot = torch.where(keep, sel_ids * cap + sel_pos, E_loc * cap)
    buf = torch.zeros((E_loc * cap + 1, D), dtype=xf.dtype, device=xf.device)
    buf[slot] = over_model(xf)[sel_tok]
    buf = buf[:E_loc * cap].view(E_loc, cap, D)

    h = F.silu(torch.bmm(buf, over_data(p.w_gate))) * torch.bmm(buf, over_data(p.w_up))
    out = torch.bmm(h, over_data(p.w_down))                    # (E_loc, cap, D)

    y_sel = out[sel_ids.clamp(max=E_loc - 1), sel_pos.clamp(max=cap - 1)]
    w_sel = over_model(weights).reshape(Tk).to(xf.dtype)[order]
    y_sel = torch.where(keep[:, None], y_sel * w_sel[:, None], 0.0)
    # each assignment owns one row of (T*k, D): the sum over a token's k
    # rows is then a plain reduction, not an atomic scatter-add
    rows = torch.zeros((Tk, D), dtype=xf.dtype, device=xf.device)
    rows[order] = y_sel
    return rows.view(T_, k, D).sum(dim=1), aux_stats


def _expert_split(cfg: ArchConfig) -> Tuple[Optional[str], int, bool]:
    """(the ``model`` axis the experts are split over, its size, whether the
    split is expert parallel) under the mesh and rules in force; size 1
    without a mesh."""
    rules = current_rules()
    tp_axis = rules.get("tp") if rules.get("expert") or rules.get("tp_ff") else None
    tp_size = _mesh_axes().get(tp_axis, 1) if tp_axis else 1
    return tp_axis, tp_size, bool(cfg.n_experts % tp_size == 0 and rules.get("expert"))


def local_experts(cfg: ArchConfig, p: MoE) -> nn.Module:
    """This rank's shard of the MoE weights ``p`` under the mesh and rules in
    force, new parameters: the router whole; of the experts, this rank's
    slice of them (expert parallel) or of their ``d_ff`` (expert TP)."""
    tp_axis, tp_size, ep = _expert_split(cfg)
    i = axis_index(tp_axis) if tp_size > 1 else 0
    if ep:
        n = cfg.n_experts // tp_size
        cut = {"w_gate": (0, n), "w_up": (0, n), "w_down": (0, n)}
    else:
        n = cfg.d_ff // tp_size
        cut = {"w_gate": (2, n), "w_up": (2, n), "w_down": (1, n)}
    shard = nn.Module()
    shard.router = nn.Parameter(p.router.detach().clone(), requires_grad=p.router.requires_grad)
    for name, (dim, size) in cut.items():
        w = getattr(p, name)
        setattr(shard, name, nn.Parameter(w.detach().narrow(dim, i * size, size).clone(),
                                          requires_grad=w.requires_grad))
    return shard


def moe_block(cfg: ArchConfig, p: MoE, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> ((B, S, D), load-balance aux scalar).

    Without a mesh, or with a ``model`` axis of size 1, the single-shard
    branch.  Otherwise x is this rank's data shard (replicated over
    ``model``) and ``p`` holds this rank's shard of the experts
    (``local_experts``): the reference's ``shard_map`` branch.  ``y`` is
    summed over ``model``; the Switch statistics are averaged over the
    batch axes before their product, and in expert-parallel mode the aux
    term is summed over ``model``.  Gradients are those of the reference's
    global arrays: the router's summed over every axis, the experts' over
    the batch axes, x's over ``model``.  The capacity follows from the local
    token count, as in the reference."""
    B, S, D = x.shape
    E = cfg.n_experts
    tp_axis, tp_size, ep = _expert_split(cfg)
    if tp_size <= 1:
        y, (f, pr) = _local_moe(cfg, x.reshape(B * S, D), p, 0, E)
        return y.reshape(B, S, D), E * torch.sum(f * pr)

    batch = _resolve("batch", _mesh_axes(), None)
    data = axis_groups((batch,) if isinstance(batch, str) else tuple(batch or ()))
    model = axis_groups((tp_axis,))
    E_loc = E // tp_size if ep else E
    e_lo = axis_index(tp_axis) * E_loc if ep else 0
    y, (f, pr) = _local_moe(cfg, x.reshape(B * S, D), p, e_lo, E_loc,
                            over_data=lambda t: pvary(t, data),
                            over_model=lambda t: pvary(t, model))
    y = psum(y, model)
    # the statistics averaged over the data shards FIRST (so the aux is
    # exactly the global Switch loss), then the expert slices combined
    aux = E * torch.sum(pmean(f, data) * pmean(pr, data))
    if ep:
        aux = psum(aux, model)
    return y.reshape(B, S, D), aux


def _moe_ffn(cfg: ArchConfig, blk: Block, h: torch.Tensor) -> torch.Tensor:
    return moe_block(cfg, blk.moe, h)[0]


# ---------------------------------------------------------------------------
# forward, loss and serving
# ---------------------------------------------------------------------------

def _block_fwd(cfg: ArchConfig, blk: Block, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pre-norm block: (its output, its load-balance aux)."""
    h = L.rms_norm(blk.norm1.w, x, cfg.norm_eps)
    x = x + L.attention_block(blk.attn, h, n_heads=cfg.n_heads,
                              n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
                              theta=cfg.rope_theta, eps=cfg.norm_eps)
    y, aux = moe_block(cfg, blk.moe, L.rms_norm(blk.norm2.w, x, cfg.norm_eps))
    return x + y, aux


def hidden(cfg: ArchConfig, params: T.Transformer, tokens: torch.Tensor, *,
           remat: str = "none") -> Tuple[torch.Tensor, torch.Tensor]:
    """(final hidden states (B, S, D), mean per-layer load-balance aux).
    Each block, its aux included, runs under the remat policy, as the
    reference's scan body does; under autograd unless the caller turns it
    off."""
    x = L.embed_lookup(params.embed, tokens)
    body = T._remat_wrap(functools.partial(_block_fwd, cfg), remat)
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in params.blocks:
        x, aux = body(blk, x)
        aux_sum = aux_sum + aux
    return x, aux_sum / cfg.n_layers


@torch.no_grad()
def apply(cfg: ArchConfig, params: T.Transformer, tokens: torch.Tensor) -> torch.Tensor:
    return T.logits_of(cfg, params, hidden(cfg, params, tokens)[0])


AUX_LOSS_COEF = 0.01   # the Switch Transformer's coefficient, as the reference's


def loss_fn(cfg: ArchConfig, params: T.Transformer, batch: Dict[str, torch.Tensor], *,
            remat: str = "none") -> torch.Tensor:
    """Mean next-token loss of ``batch`` ({"tokens", "labels"}, (B, S)) plus
    AUX_LOSS_COEF times the mean per-layer load-balance term."""
    x, aux = hidden(cfg, params, batch["tokens"], remat=remat)
    return T.lm_loss(cfg, params, x, batch["labels"]) + AUX_LOSS_COEF * aux


def prefill(cfg: ArchConfig, params: T.Transformer, tokens: torch.Tensor,
            max_seq: Optional[int] = None) -> Tuple[torch.Tensor, T.Cache]:
    return T.prefill(cfg, params, tokens, max_seq, ffn=_moe_ffn)


def decode_step(cfg: ArchConfig, params: T.Transformer, cache: T.Cache,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, T.Cache]:
    return T.decode_step(cfg, params, cache, tokens, ffn=_moe_ffn)
