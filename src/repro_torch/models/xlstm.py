"""xLSTM (sLSTM + mLSTM blocks), xlstm-350m, ported from
``repro/models/xlstm.py`` (arXiv:2405.04517).

* mLSTM: the matrix-memory cell.  Training and prefill run the stabilized
  chunkwise-parallel form above one chunk (the parallel, attention-like
  form at or below it, or where the length is not a multiple of the
  chunk); decode runs the O(1) recurrent step.
* sLSTM: the scalar-memory cell with block-diagonal recurrent weights, a
  Python loop over time.
* One sLSTM block closes each group of ``slstm_every`` blocks (xLSTM[7:1]);
  there is no separate FFN.

The layers are modules: ``mlstm[g][j]`` is the j-th mLSTM block of group g
and ``slstm[g]`` the group's sLSTM block (the reference stacks them
``(G, slstm_every - 1, ...)`` and ``(G, ...)``; ``interop`` maps the names).
Five parameters stay f32 in a bf16 model, as in the reference: the mLSTM's
``w_if`` and ``b_gates``, the sLSTM's ``w_gates``, ``r_gates`` and
``b_gates``.  No repo kernel runs here: the reference has no Pallas kernel
for either cell, and the port computes both with plain PyTorch ops, on the
card as on the CPU.

Two details keep the gradients the reference's.  ``torch.maximum`` of two
tensors splits the gradient in half at a tie, as ``lax.max`` does (and
``clamp_min`` does not): the sLSTM's normaliser is exactly 1 at its first
step, where it meets ``max(n, 1)``.  ``torch.amax`` spreads a reduction's
gradient over tied maxima, as JAX's ``max`` does.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..configs.base import ArchConfig
from . import layers as L
from . import transformer as T
from .mamba2 import _causal_conv

__all__ = ["XLSTM", "Model", "dims", "n_groups", "init", "mlstm_parallel",
           "mlstm_chunkwise", "mlstm_step", "slstm_forward", "slstm_step", "hidden",
           "apply", "loss_fn", "init_cache", "decode_step", "prefill"]

Cache = T.Cache
Cell = Dict[str, torch.Tensor]
_NEG = -1e30


def dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(d_inner, H mLSTM heads, head width)."""
    d_inner = 2 * cfg.d_model
    return d_inner, cfg.n_heads, d_inner // cfg.n_heads


def n_groups(cfg: ArchConfig) -> int:
    if cfg.n_layers % cfg.slstm_every:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                         f"slstm_every {cfg.slstm_every}")
    return cfg.n_layers // cfg.slstm_every


class MLSTM(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        D = cfg.d_model
        d_inner, H, _ = dims(cfg)
        f32 = torch.float32
        self.w_up = L._param((D, 2 * d_inner), device, dtype)
        self.conv_w = L._param((cfg.conv_kernel, d_inner), device, dtype)
        self.w_qkv = L._param((d_inner, 3 * d_inner), device, dtype)
        self.w_if = L._param((d_inner, 2 * H), device, f32)
        self.b_gates = L._param((2 * H,), device, f32)
        self.gn = L._param((d_inner,), device, dtype)
        self.w_down = L._param((d_inner, D), device, dtype)


class SLSTM(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        D, H = cfg.d_model, cfg.n_heads
        f32 = torch.float32
        self.conv_w = L._param((cfg.conv_kernel, D), device, dtype)
        self.w_gates = L._param((D, 4 * D), device, f32)              # z, i, f, o
        self.r_gates = L._param((4, H, D // H, D // H), device, f32)  # per gate, per head
        self.b_gates = L._param((4 * D,), device, f32)
        self.gn = L._param((D,), device, dtype)
        self.w_down = L._param((D, D), device, dtype)


class MLSTMBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        self.norm1 = L.RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.mlstm = MLSTM(cfg, device=device, dtype=dtype)


class SLSTMBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        self.norm1 = L.RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.slstm = SLSTM(cfg, device=device, dtype=dtype)


class XLSTM(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        G, m_per = n_groups(cfg), cfg.slstm_every - 1
        self.embed = L.Embed(cfg.vocab, cfg.d_model, **kw)
        self.mlstm = nn.ModuleList(
            nn.ModuleList(MLSTMBlock(cfg, **kw) for _ in range(m_per)) for _ in range(G))
        self.slstm = nn.ModuleList(SLSTMBlock(cfg, **kw) for _ in range(G))
        self.final_norm = L.RMSNorm(cfg.d_model, **kw)
        self.lm_head = nn.Module()
        self.lm_head.w = L._param((cfg.d_model, cfg.vocab), device, dtype)


Model = XLSTM


def init(cfg: ArchConfig, seed: int = 0, *, device=None) -> XLSTM:
    """Random weights from a seeded ``torch.Generator``, drawn on ``device``
    in the config's dtype, the five gate parameters in f32
    (``layers.init_weights_``)."""
    device = resolve_device(device)
    return L.init_weights_(XLSTM(cfg, device=device, dtype=T.dtype_of(cfg)), seed, device)


def _head_norm(y: torch.Tensor, gn: torch.Tensor, H: int, eps: float,
               dtype: torch.dtype) -> torch.Tensor:
    """Per-head RMS norm of y (B, S, H * hd) in f32, times ``gn``, cast to
    ``dtype``."""
    B, S, Dy = y.shape
    yf = y.float().reshape(B, S, H, Dy // H)
    y = (yf * torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + eps)).reshape(B, S, Dy)
    return (y * gn.float()).to(dtype)


# ---------------------------------------------------------------------------
# mLSTM: parallel and chunkwise forms, recurrent step
# ---------------------------------------------------------------------------

def _mlstm_qkvif(cfg: ArchConfig, p: MLSTM, x: torch.Tensor):
    """q, k, v (B,S,H,hd), the input and forget preactivations (B,S,H) f32,
    the output gate's z and the pre-conv branch xm (B,S,d_inner)."""
    d_inner, H, hd = dims(cfg)
    up = x @ p.w_up
    xm, z = up[..., :d_inner], up[..., d_inner:]
    q, k, v = (_causal_conv(xm, p.conv_w) @ p.w_qkv).split(d_inner, dim=-1)
    v = xm * v                      # the value path gated by the pre-conv branch
    # the reference's product: x's dtype times w_if rounded to it, summed
    # and returned in f32 (each product of two bf16 values is exact in f32)
    gates = xm.float() @ p.w_if.to(xm.dtype).float() + p.b_gates
    B, S = x.shape[:2]
    q, k, v = (t.reshape(B, S, H, hd) for t in (q, k, v))
    return q, k, v, gates[..., :H], gates[..., H:], z, xm


def _mlstm_out(cfg: ArchConfig, p: MLSTM, y: torch.Tensor, z: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """Per-head norm, the silu(z) gate and the down projection."""
    y = _head_norm(y, p.gn, cfg.n_heads, cfg.norm_eps, dtype)
    return (y * L.silu(z)) @ p.w_down


def mlstm_parallel(cfg: ArchConfig, p: MLSTM, x: torch.Tensor) -> torch.Tensor:
    """Stabilized parallel mLSTM, quadratic in S.  x: (B,S,D) -> (B,S,D)."""
    d_inner, H, hd = dims(cfg)
    B, S, _ = x.shape
    q, k, v, i_pre, f_pre, z, _ = _mlstm_qkvif(cfg, p, x)
    Fc = torch.cumsum(F.logsigmoid(f_pre), dim=1).transpose(1, 2)        # (B,H,S)
    # logD[b,h,s,t] = F_s - F_t + i_t   (t <= s)
    logD = Fc[..., :, None] - Fc[..., None, :] + i_pre.transpose(1, 2)[..., None, :]
    causal = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    logD = logD.masked_fill(~causal, float("-inf"))
    m = torch.amax(logD, dim=-1)                                         # (B,H,S)
    scores = torch.einsum("bshd,bthd->bhst", q, k).float()
    scores = scores * hd ** -0.5 * torch.exp(logD - m[..., None])
    norm = torch.maximum(scores.sum(-1).abs(), torch.exp(-m))           # (B,H,S)
    y = torch.einsum("bhst,bthd->bshd", (scores / norm[..., None]).to(v.dtype), v)
    return _mlstm_out(cfg, p, y.reshape(B, S, d_inner), z, x.dtype)


def mlstm_chunkwise(cfg: ArchConfig, p: MLSTM, x: torch.Tensor,
                    return_state: bool = False):
    """Chunkwise-parallel stabilized mLSTM (the xLSTM paper's appendix A):
    the parallel form's result, quadratic only within chunks of Q =
    min(chunk, S) positions, the matrix memory carried from chunk to chunk
    in f32.  Falls back to ``mlstm_parallel`` where S % Q != 0.  With
    ``return_state`` also returns the decode cell {C, n, m, conv} after the
    last position (the prefill path), which needs S % Q == 0."""
    d_inner, H, hd = dims(cfg)
    B, S, _ = x.shape
    Q = min(cfg.chunk, S)
    if S % Q:
        if return_state:
            raise ValueError(f"prefill length {S} is not a multiple of the chunk {Q}")
        return mlstm_parallel(cfg, p, x)
    nc = S // Q
    q, k, v, i_pre, f_pre, z, xm = _mlstm_qkvif(cfg, p, x)

    def chunks(t):     # (B, S, ...) -> (B, nc, Q, ...)
        return t.reshape(B, nc, Q, *t.shape[2:])

    qc, kc, vc = chunks(q.float()), chunks(k.float() * hd ** -0.5), chunks(v.float())
    ic = chunks(i_pre)                                                   # (B,nc,Q,H)
    b = torch.cumsum(chunks(F.logsigmoid(f_pre)), dim=2)                 # inclusive
    b_tot = b[:, :, -1]                                                  # (B,nc,H)
    # intra-chunk log weights lw[i, j] = b_i - b_j + i_j (j <= i)
    bt = b.transpose(2, 3)                                               # (B,nc,H,Q)
    lw = bt[..., :, None] - bt[..., None, :] + ic.transpose(2, 3)[..., None, :]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    lw = lw.masked_fill(~tri, float("-inf"))                             # (B,nc,H,Q,Q)
    m_intra = torch.amax(lw, dim=-1)                                     # (B,nc,H,Q)

    C = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
    n = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
    m = torch.full((B, H), _NEG, dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        qh, kh, vh = (t[:, c].transpose(1, 2) for t in (qc, kc, vc))     # (B,H,Q,hd)
        bx, ix, btot = b[:, c], ic[:, c], b_tot[:, c]                    # (B,Q,H), (B,H)
        w_inter = bx.transpose(1, 2) + m[..., None]                      # (B,H,Q)
        m_i = torch.maximum(m_intra[:, c], w_inter)
        d_intra = torch.exp(lw[:, c] - m_i[..., None])                   # (B,H,Q,Q)
        d_inter = torch.exp(w_inter - m_i)                               # (B,H,Q)
        scores = (qh @ kh.transpose(-1, -2)) * d_intra
        num = scores @ vh + (qh @ C.transpose(-1, -2)) * d_inter[..., None]
        den = torch.maximum((scores.sum(-1) + (qh @ n[..., None])[..., 0] * d_inter).abs(),
                            torch.exp(-m_i))                             # (B,H,Q)
        ys.append((num / den[..., None]).transpose(1, 2))                # (B,Q,H,hd)
        # the carry, stabilized: dj is position q's decay to the chunk end
        dj = btot[:, None, :] - bx + ix                                  # (B,Q,H)
        m_next = torch.maximum(btot + m, torch.amax(dj, dim=1))          # (B,H)
        fs = torch.exp(btot + m - m_next)
        wj = torch.exp(dj - m_next[:, None, :]).transpose(1, 2)[..., None]   # (B,H,Q,1)
        C = fs[..., None, None] * C + (vh * wj).transpose(-1, -2) @ kh
        n = fs[..., None] * n + (kh * wj).sum(2)
        m = m_next
    y = torch.stack(ys, dim=1).reshape(B, S, d_inner)
    out = _mlstm_out(cfg, p, y, z, x.dtype)
    if not return_state:
        return out
    # the conv cache holds the last K-1 raw (pre-conv) xm inputs
    return out, {"C": C, "n": n, "m": m, "conv": xm[:, S - (cfg.conv_kernel - 1):]}


def mlstm_step(cfg: ArchConfig, p: MLSTM, x: torch.Tensor, cell: Cell
               ) -> Tuple[torch.Tensor, Cell]:
    """The recurrent O(1) step.  x: (B,1,D); cell: {C (B,H,hd,hd), n
    (B,H,hd), m (B,H), conv (B,K-1,d_inner)}.  Returns the output and a new
    cell; the input cell is not modified.  The gate product is f32 times
    the f32 ``w_if``, as the reference's step computes it (its parallel
    forms round ``w_if`` to x's dtype)."""
    d_inner, H, hd = dims(cfg)
    B = x.shape[0]
    up = x @ p.w_up
    xm, z = up[..., :d_inner], up[..., d_inner:]
    window = torch.cat([cell["conv"], xm], dim=1)
    c = L.silu(torch.einsum("bkc,kc->bc", window, p.conv_w))[:, None]
    q, k, v = (c @ p.w_qkv).split(d_inner, dim=-1)
    v = xm * v
    gates = xm.float() @ p.w_if + p.b_gates
    i_pre, f_pre = gates[:, 0, :H], gates[:, 0, H:]                      # (B,H)
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + cell["m"], i_pre)
    fs = torch.exp(logf + cell["m"] - m_new)[..., None]
    is_ = torch.exp(i_pre - m_new)[..., None]
    qh = q.reshape(B, H, hd).float()
    kh = k.reshape(B, H, hd).float() * hd ** -0.5
    vh = v.reshape(B, H, hd).float()
    C = fs[..., None] * cell["C"] + is_[..., None] * (vh[..., :, None] * kh[..., None, :])
    n = fs * cell["n"] + is_ * kh
    num = (C @ qh[..., None])[..., 0]                                    # (B,H,hd)
    den = torch.maximum((n * qh).sum(-1).abs(), torch.exp(-m_new))[..., None]
    out = _mlstm_out(cfg, p, (num / den).reshape(B, 1, d_inner), z, x.dtype)
    return out, {"C": C, "n": n, "m": m_new, "conv": window[:, 1:]}


# ---------------------------------------------------------------------------
# sLSTM: the sequential cell
# ---------------------------------------------------------------------------

def _recurrent_weights(p: SLSTM) -> torch.Tensor:
    """``r_gates`` (4, H, hd, hd) as (H, hd, 4 hd): ``h @ rT[h]`` is the
    reference's ``einsum("ghij,bhj->bghi", r, h)`` for head h, its four
    gates side by side."""
    _, H, hd, _ = p.r_gates.shape
    return p.r_gates.permute(1, 3, 0, 2).reshape(H, hd, 4 * hd)


def _slstm_cell(rT: torch.Tensor, xt: torch.Tensor, state: Cell, one: torch.Tensor
                ) -> Tuple[torch.Tensor, Cell]:
    """One time step in head-major layout.  xt: (H, B, 4 hd) input
    preactivations, gates z, i, f, o side by side; state holds h, c, n, m,
    each (H, B, hd) f32; ``rT`` from ``_recurrent_weights``; ``one`` a
    0-dim f32 1.  The recurrent product and the input add are one
    ``baddbmm``."""
    zp, ip, fp, op = torch.baddbmm(xt, state["h"], rT).chunk(4, dim=-1)
    logf_m = F.logsigmoid(fp) + state["m"]
    m_new = torch.maximum(logf_m, ip)
    i_s = torch.exp(ip - m_new)
    f_s = torch.exp(logf_m - m_new)
    c = f_s * state["c"] + i_s * torch.tanh(zp)
    n = f_s * state["n"] + i_s
    h = torch.sigmoid(op) * c / torch.maximum(n, one)
    return h, {"h": h, "c": c, "n": n, "m": m_new}


def _head_major(t: torch.Tensor, H: int, parts: int = 1) -> torch.Tensor:
    """(..., B, parts * D) laid out (part, head, width) -> (..., H, B,
    parts * hd), each head's parts side by side."""
    *lead, B, W = t.shape
    hd = W // parts // H
    t = t.reshape(*lead, B, parts, H, hd).movedim(-2, -4)        # (..., H, B, parts, hd)
    return t.reshape(*lead, H, B, parts * hd)


def _slstm_out(cfg: ArchConfig, p: SLSTM, h: torch.Tensor, dtype: torch.dtype
               ) -> torch.Tensor:
    return _head_norm(h, p.gn, cfg.n_heads, cfg.norm_eps, dtype) @ p.w_down


def slstm_forward(cfg: ArchConfig, p: SLSTM, x: torch.Tensor, return_state: bool = False):
    """The sLSTM over time, step by step.  x: (B,S,D).  With
    ``return_state`` also returns the final cell {h, c, n, m, conv}.  The
    loop runs head-major ((H, B, hd) states, the inputs' gates laid out
    per head once before it), which makes each step's recurrent product one
    batched product with no copies."""
    B, S, D = x.shape
    H = cfg.n_heads
    xg = _causal_conv(x, p.conv_w).float() @ p.w_gates + p.b_gates      # (B,S,4D)
    xg = _head_major(xg.transpose(0, 1), H, 4)                           # (S,H,B,4hd)
    zeros = torch.zeros((H, B, D // H), dtype=torch.float32, device=x.device)
    state = {"h": zeros, "c": zeros, "n": zeros, "m": torch.full_like(zeros, _NEG)}
    one = torch.ones((), dtype=torch.float32, device=x.device)
    rT = _recurrent_weights(p)
    hs = []
    for t in range(S):
        h, state = _slstm_cell(rT, xg[t], state, one)
        hs.append(h)
    y = torch.stack(hs, dim=2).permute(1, 2, 0, 3).reshape(B, S, D)     # (H,B,S,hd) ->
    out = _slstm_out(cfg, p, y, x.dtype)
    if not return_state:
        return out
    cell = {k: v.transpose(0, 1).reshape(B, D) for k, v in state.items()}
    cell["conv"] = x[:, S - (cfg.conv_kernel - 1):]
    return out, cell


def slstm_step(cfg: ArchConfig, p: SLSTM, x: torch.Tensor, cell: Cell
               ) -> Tuple[torch.Tensor, Cell]:
    """x: (B,1,D); cell: {h, c, n, m (B,D), conv (B,K-1,D)}.  Returns the
    output and a new cell."""
    B, _, D = x.shape
    H = cfg.n_heads
    window = torch.cat([cell["conv"], x], dim=1)
    c = L.silu(torch.einsum("bkc,kc->bc", window, p.conv_w))
    xg = _head_major(c.float() @ p.w_gates + p.b_gates, H, 4)
    one = torch.ones((), dtype=torch.float32, device=x.device)
    state = {k: _head_major(cell[k], H) for k in ("h", "c", "n", "m")}
    h, st = _slstm_cell(_recurrent_weights(p), xg, state, one)
    st = {k: v.transpose(0, 1).reshape(B, D) for k, v in st.items()}
    st["conv"] = window[:, 1:]
    return _slstm_out(cfg, p, st["h"][:, None], x.dtype), st


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _mlstm_block_fwd(cfg: ArchConfig, blk: MLSTMBlock, x: torch.Tensor) -> torch.Tensor:
    """Pre-norm residual mLSTM block: the chunkwise form above one chunk,
    the parallel form at or below it."""
    h = L.rms_norm(blk.norm1.w, x, cfg.norm_eps)
    form = mlstm_chunkwise if x.shape[1] > cfg.chunk else mlstm_parallel
    return x + form(cfg, blk.mlstm, h)


def _group(cfg: ArchConfig, params: XLSTM, g: int, x: torch.Tensor) -> torch.Tensor:
    """Group ``g``: its mLSTM blocks, then its sLSTM block."""
    for blk in params.mlstm[g]:
        x = _mlstm_block_fwd(cfg, blk, x)
    sblk = params.slstm[g]
    return x + slstm_forward(cfg, sblk.slstm, L.rms_norm(sblk.norm1.w, x, cfg.norm_eps))


def hidden(cfg: ArchConfig, params: XLSTM, tokens: torch.Tensor, *,
           remat: str = "none") -> torch.Tensor:
    """Embedding and every group: tokens (B, S) -> hidden (B, S, D).  Each
    group runs under the remat policy, as the reference's scan body does;
    under autograd unless the caller turns it off."""
    x = L.embed_lookup(params.embed, tokens)
    body = T._remat_wrap(functools.partial(_group, cfg, params), remat)
    for g in range(n_groups(cfg)):
        x = body(g, x)
    return x


@torch.no_grad()
def apply(cfg: ArchConfig, params: XLSTM, tokens: torch.Tensor) -> torch.Tensor:
    return T.logits_of(cfg, params, hidden(cfg, params, tokens))


def loss_fn(cfg: ArchConfig, params: XLSTM, batch: Dict[str, torch.Tensor], *,
            remat: str = "none") -> torch.Tensor:
    """Mean next-token loss of ``batch`` ({"tokens", "labels"}, (B, S))."""
    x = hidden(cfg, params, batch["tokens"], remat=remat)
    return T.lm_loss(cfg, params, x, batch["labels"])


# ---------------------------------------------------------------------------
# serving: the state is O(1) in the sequence length
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype: Optional[torch.dtype] = None, *, device=None) -> Cache:
    """Every cell of every block at its start (nothing scales with
    ``max_seq``): the mLSTM cells ``m_*`` (G, slstm_every-1, B, ...), the
    sLSTM cells ``s_*`` (G, B, ...), f32 but for the conv windows."""
    device = resolve_device(device)
    dtype = dtype or T.dtype_of(cfg)
    d_inner, H, hd = dims(cfg)
    G, m_per, D, K = n_groups(cfg), cfg.slstm_every - 1, cfg.d_model, cfg.conv_kernel

    def zeros(*shape, dt=torch.float32):
        return torch.zeros(shape, dtype=dt, device=device)

    def neg(*shape):
        return torch.full(shape, _NEG, dtype=torch.float32, device=device)

    return {
        "m_C": zeros(G, m_per, batch, H, hd, hd), "m_n": zeros(G, m_per, batch, H, hd),
        "m_m": neg(G, m_per, batch, H), "m_conv": zeros(G, m_per, batch, K - 1, d_inner,
                                                         dt=dtype),
        "s_h": zeros(G, batch, D), "s_c": zeros(G, batch, D), "s_n": zeros(G, batch, D),
        "s_m": neg(G, batch, D), "s_conv": zeros(G, batch, K - 1, D, dt=dtype),
        "index": zeros(dt=torch.int32),
    }


_M_KEYS = ("C", "n", "m", "conv")
_S_KEYS = ("h", "c", "n", "m", "conv")


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: XLSTM, cache: Cache, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Cache]:
    """One decode step: tokens (B, 1) -> logits (B, 1, V) and the cache,
    whose cells are updated IN PLACE and whose index advances."""
    x = L.embed_lookup(params.embed, tokens)
    for g in range(n_groups(cfg)):
        for j, blk in enumerate(params.mlstm[g]):
            hn = L.rms_norm(blk.norm1.w, x, cfg.norm_eps)
            out, cell = mlstm_step(cfg, blk.mlstm, hn,
                                   {k: cache[f"m_{k}"][g, j] for k in _M_KEYS})
            x = x + out
            for k in _M_KEYS:
                cache[f"m_{k}"][g, j] = cell[k]
        sblk = params.slstm[g]
        hn = L.rms_norm(sblk.norm1.w, x, cfg.norm_eps)
        out, cell = slstm_step(cfg, sblk.slstm, hn, {k: cache[f"s_{k}"][g] for k in _S_KEYS})
        x = x + out
        for k in _S_KEYS:
            cache[f"s_{k}"][g] = cell[k]
    return T.logits_of(cfg, params, x), {**cache, "index": cache["index"] + 1}


@torch.no_grad()
def prefill(cfg: ArchConfig, params: XLSTM, tokens: torch.Tensor,
            max_seq: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt: last-position logits (B, 1, V) and the cells after
    it.  The mLSTM blocks run the chunkwise form, each returning its final
    cell, and the sLSTM blocks their loop over the prompt; a prompt that is
    not a multiple of the chunk, or of at most ``conv_kernel`` tokens, is
    stepped through token by token instead, as the reference does."""
    B, S = tokens.shape
    cache = init_cache(cfg, B, max_seq or S, device=tokens.device)
    if S % min(cfg.chunk, S) or S <= cfg.conv_kernel:
        for t in range(S):
            logits, cache = decode_step(cfg, params, cache, tokens[:, t:t + 1])
        return logits, cache
    x = L.embed_lookup(params.embed, tokens)
    for g in range(n_groups(cfg)):
        for j, blk in enumerate(params.mlstm[g]):
            h = L.rms_norm(blk.norm1.w, x, cfg.norm_eps)
            out, cell = mlstm_chunkwise(cfg, blk.mlstm, h, return_state=True)
            x = x + out
            for k in _M_KEYS:
                cache[f"m_{k}"][g, j] = cell[k]
        sblk = params.slstm[g]
        h = L.rms_norm(sblk.norm1.w, x, cfg.norm_eps)
        out, cell = slstm_forward(cfg, sblk.slstm, h, return_state=True)
        x = x + out
        for k in _S_KEYS:
            cache[f"s_{k}"][g] = cell[k]
    cache["index"] = torch.tensor(S, dtype=torch.int32, device=x.device)
    return T.logits_of(cfg, params, x[:, -1:]), cache
