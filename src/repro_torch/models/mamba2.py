"""Mamba2 (SSD) blocks, the zamba2 backbone, ported from
``repro/models/mamba2.py``.

As in the reference: separate z/x/B/C/dt slices of one input projection, a
depthwise causal conv (K=4, unrolled), the chunked SSD algorithm (quadratic
intra-chunk products plus the inter-chunk state recurrence, which runs
through ``ops.ssd_state_scan``: the CUDA kernel on the card), a per-head
gated RMS norm, and an O(1) recurrent decode step.

The reference's four-operand einsum ``bcsn,bctn,bchst,bcthp->bcshp`` is
written out as three products (C·Bᵀ, times the decay mask, times x): left to
``torch.einsum``'s own order its intermediate can grow to (b,c,s,t,h,p),
about 8 GB at zamba2's H=64, P=80, Q=256.  The ``states`` and ``y_off``
contractions are written out the same way.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..configs.base import ArchConfig
from ..kernels import ops
from . import layers as L
from .sharding import shard

__all__ = ["SSM", "SSMBlock", "dims", "init_ssm_block", "ssd_forward", "ssd_chunked",
           "ssm_block_core", "ssm_block_apply", "init_ssm_cache", "ssm_decode_step"]


def dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    """(d_inner, H value heads, P head width, N state size)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    H = cfg.ssm_heads
    return d_inner, H, d_inner // H, cfg.ssm_state


class SSM(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        d_inner, H, P, N = dims(cfg)
        D = cfg.d_model
        self.in_proj = L._param((D, 2 * d_inner + 2 * N + H), device, dtype)
        self.conv_w = L._param((cfg.conv_kernel, d_inner + 2 * N), device, dtype)
        self.dt_bias = L._param((H,), device, torch.float32)
        self.a_log = L._param((H,), device, torch.float32)
        self.d_skip = L._param((H,), device, torch.float32)
        self.norm = L._param((d_inner,), device, dtype)
        self.out_proj = L._param((d_inner, D), device, dtype)


class SSMBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        self.norm1 = L.RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.ssm = SSM(cfg, device=device, dtype=dtype)


def init_ssm_block(cfg: ArchConfig, seed: int = 0, *, device=None) -> SSMBlock:
    """One block's weights: normal / sqrt(fan_in) projections, conv normal *
    0.1, ``a_log = log(linspace(1, 16, H))``, ``dt_bias`` 0, ``d_skip`` 1,
    norms 1 (``layers.init_weights_``)."""
    device = resolve_device(device)
    return L.init_weights_(SSMBlock(cfg, device=device, dtype=getattr(torch, cfg.dtype)),
                           seed, device)


def _split_proj(cfg: ArchConfig, proj: torch.Tensor):
    d_inner, H, P, N = dims(cfg)
    return torch.split(proj, [d_inner, d_inner, N, N, H], dim=-1)   # z, x, B, C, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d, then SiLU.  xbc: (B, S, C), w: (K, C)."""
    K, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(K):  # K is 4: unrolled adds, as in the reference
        out = out + pad[:, i:i + S, :] * w[i]
    return L.silu(out)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q) log-decay increments -> (..., Q, Q) lower-triangular
    cumulative sums out[s, t] = sum_{t < tau <= s} a[tau], -inf above."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    lower = torch.ones((Q, Q), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~lower, float("-inf"))


def _pad_to_chunks(Q: int, *arrays: torch.Tensor):
    """Zero-pad the seq dim (dim 1) to a multiple of Q.  Padded steps have
    dt=0, so decay 1 and contribution 0: states and outputs are unaffected."""
    S = arrays[0].shape[1]
    pad = (-S) % Q
    if pad == 0:
        return S, arrays
    return S, tuple(F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad)) for a in arrays)


def ssd_chunked(cfg: ArchConfig, x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, d_skip: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.  x: (B,S,H,P), dt: (B,S,H) (post-softplus), Bm/Cm:
    (B,S,N).  Returns (y (B,S,H,P) in x's dtype, the final state (B,H,P,N)
    f32, which ``hybrid.prefill`` keeps for decoding)."""
    Q = min(cfg.chunk, x.shape[1])
    S0, (x, dt, Bm, Cm) = _pad_to_chunks(Q, x, dt, Bm, Cm)
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = S // Q

    A = -torch.exp(a_log.float())                            # (H,)
    a = dt * A                                               # (B,S,H) log decay
    xd = x * dt[..., None].to(x.dtype)                       # dt-discretized
    a_c = a.reshape(Bb, nc, Q, H)
    xd_c = xd.reshape(Bb, nc, Q, H, P).float()
    B_c = Bm.reshape(Bb, nc, Q, N).float()
    C_c = Cm.reshape(Bb, nc, Q, N).float()
    a_cs = torch.cumsum(a_c, dim=2)                          # (B,nc,Q,H)
    xd_h = xd_c.permute(0, 1, 3, 2, 4)                       # (B,nc,H,Q,P)

    # intra-chunk: y_diag[s,h,p] = sum_t (C[s].B[t]) L[h,s,t] xd[t,h,p]
    Lmat = torch.exp(_segsum(a_c.movedim(-1, 2)))            # (B,nc,H,Q,Q)
    CB = C_c @ B_c.transpose(-1, -2)                         # (B,nc,Q,Q)
    y_diag = (Lmat * CB[:, :, None]) @ xd_h                  # (B,nc,H,Q,P)
    # chunk states: decay each position to the chunk end,
    # states[h,p,n] = sum_t xd[t,h,p] decay[t,h] B[t,n]
    decay_states = torch.exp(a_cs[:, :, -1:, :] - a_cs)      # (B,nc,Q,H)
    xs = xd_h * decay_states.permute(0, 1, 3, 2)[..., None]  # (B,nc,H,Q,P)
    states = xs.transpose(-1, -2) @ B_c[:, :, None]          # (B,nc,H,P,N)
    chunk_decay = torch.exp(a_cs[:, :, -1, :])               # (B,nc,H)
    # inter-chunk recurrence (the CUDA kernel on the card)
    prefix, final = ops.ssd_state_scan(states.contiguous(), chunk_decay.contiguous())
    # y_off[s,h,p] = sum_n C[s,n] prefix[h,p,n] exp(a_cs[s,h])
    y_off = (C_c[:, :, None] @ prefix.transpose(-1, -2)) \
        * torch.exp(a_cs).permute(0, 1, 3, 2)[..., None]     # (B,nc,H,Q,P)
    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(Bb, S, H, P).to(x.dtype)
    y = y + x * d_skip.to(x.dtype)[None, None, :, None]
    return y[:, :S0], final


def ssd_forward(cfg: ArchConfig, x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, d_skip: torch.Tensor) -> torch.Tensor:
    """Chunked SSD: y (B,S,H,P) (see ``ssd_chunked``)."""
    return ssd_chunked(cfg, x, dt, a_log, Bm, Cm, d_skip)[0]


def _gated_headnorm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor, H: int,
                    eps: float) -> torch.Tensor:
    """Per-head RMS over P of (y * silu(z)); w: (d_inner,)."""
    B, S, d_inner = y.shape
    gf = (y * L.silu(z)).reshape(B, S, H, d_inner // H).float()
    var = torch.mean(gf * gf, dim=-1, keepdim=True)
    g = (gf * torch.rsqrt(var + eps)).to(y.dtype).reshape(B, S, d_inner)
    return g * w


def ssm_block_core(cfg: ArchConfig, blk: SSMBlock, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Mamba2 block (pre-norm residual), x: (B,S,D).  Returns (its
    output, the final SSD state (B,H,P,N) f32, the block's conv input
    (B,S,conv_dim) before the convolution)."""
    d_inner, H, P, N = dims(cfg)
    p = blk.ssm
    h = L.rms_norm(blk.norm1.w, x, cfg.norm_eps)
    z, xin, Bm, Cm, dtp = _split_proj(cfg, h @ p.in_proj)
    xbc_in = torch.cat([xin, Bm, Cm], dim=-1)
    xin, Bm, Cm = torch.split(_causal_conv(xbc_in, p.conv_w), [d_inner, N, N], dim=-1)
    dt = F.softplus(dtp.float() + p.dt_bias)
    Bsz, S = x.shape[:2]
    # the scan's inputs whole along the sequence: under a mesh DTensor may
    # resolve the projection's FSDP partial sum by splitting positions,
    # which the chunk reshapes cannot carry
    xh = shard(xin.reshape(Bsz, S, H, P), "batch", None, "tp", None)
    dt = shard(dt, "batch", None, "tp")
    Bm, Cm = (shard(t, "batch", None, None) for t in (Bm, Cm))
    y, final = ssd_chunked(cfg, xh, dt, p.a_log, Bm, Cm, p.d_skip)
    y = _gated_headnorm(y.reshape(Bsz, S, d_inner), z, p.norm, H, cfg.norm_eps)
    return x + L._reduced(y @ p.out_proj), final, xbc_in


def ssm_block_apply(cfg: ArchConfig, blk: SSMBlock, x: torch.Tensor) -> torch.Tensor:
    """One Mamba2 block (pre-norm residual). x: (B,S,D)."""
    return ssm_block_core(cfg, blk, x)[0]


# ---------------------------------------------------------------------------
# decode (recurrent O(1) step)
# ---------------------------------------------------------------------------

def init_ssm_cache(cfg: ArchConfig, n_blocks: int, batch: int,
                   dtype: Optional[torch.dtype] = None, *, device=None):
    device = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    d_inner, H, P, N = dims(cfg)
    return {
        "state": torch.zeros((n_blocks, batch, H, P, N), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((n_blocks, batch, cfg.conv_kernel - 1, d_inner + 2 * N),
                            dtype=dtype, device=device),
    }


def ssm_decode_step(cfg: ArchConfig, blk: SSMBlock, x: torch.Tensor,
                    state: torch.Tensor, conv_cache: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B,1,D); state: (B,H,P,N); conv_cache: (B,K-1,conv_dim).  Returns
    (output (B,1,D), new state, new conv cache); the inputs are not
    modified."""
    d_inner, H, P, N = dims(cfg)
    p = blk.ssm
    h = L.rms_norm(blk.norm1.w, x, cfg.norm_eps)
    z, xin, Bm, Cm, dtp = _split_proj(cfg, h @ p.in_proj)
    xbc = torch.cat([xin, Bm, Cm], dim=-1)                   # (B,1,conv_dim)
    window = torch.cat([conv_cache, xbc], dim=1)             # (B,K,conv_dim)
    conv_out = L.silu(torch.einsum("bkc,kc->bc", window, p.conv_w))
    xin, Bm, Cm = torch.split(conv_out, [d_inner, N, N], dim=-1)
    dt = F.softplus(dtp.float() + p.dt_bias)[:, 0]           # (B,H)
    a = torch.exp(dt * -torch.exp(p.a_log.float()))          # (B,H)
    Bsz = x.shape[0]
    xh = xin.reshape(Bsz, H, P).float()
    upd = (dt[..., None] * xh)[..., None] * Bm.float()[:, None, None, :]
    state = a[..., None, None] * state + upd                 # (B,H,P,N)
    y = (state @ Cm.float()[:, None, :, None])[..., 0]       # (B,H,P)
    y = y + xh * p.d_skip[None, :, None]
    y = y.reshape(Bsz, 1, d_inner).to(x.dtype)
    y = _gated_headnorm(y, z, p.norm, H, cfg.norm_eps)
    return x + L._reduced(y @ p.out_proj), state, window[:, 1:]
