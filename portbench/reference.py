"""The plain reference: a model in float32, written from its published
description, and the same model's training step with AdamW.

The blocks of a model are its family's (``families/<family>.py``: ``embed``,
``block``, ``final_logits``), built from the operations here (``linear``,
``rms``, ``rope``, ``causal_attention``); this module holds what every
family shares: the teacher-forced check of served tokens, and the training
step's loss, global norm clip and AdamW.

It imports nothing of the program and calls none of its operations, and
neither may a family's blocks.  Its weights come from
``weights.draw_group`` (the same seeded tensors the program was given) and
are cast to float32; TF32 is off while it runs.  It works layer by layer
over the sequences it checks, attention in blocks of query rows, so that it
fits beside nothing else on the card.

``quant="fp8"`` is the control: every matrix product's inputs rounded to
float8 e4m3 (a scale per row of the activations and per column of the
weights), the precision step below the configuration's bfloat16.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .weights import draw_group, leaf_names

__all__ = ["strict_f32", "fp8_round", "linear", "rms", "rope", "causal_attention",
           "served_gaps", "TrainReference", "warmup_cosine", "leaf_gaps"]

Weights = Dict[str, torch.Tensor]
ATTN_ROWS = 1024        # query rows of one block of scores
LOSS_CHUNK = 1024       # tokens of one chunk of the loss


class strict_f32:
    """Turns TF32 off for float32 products while the reference runs."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                      torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) = self.saved[:2]
        torch.set_float32_matmul_precision(self.saved[2])
        return False


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (its largest magnitude maps to 448), back in x's dtype."""
    amax = x.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


def linear(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    if quant == "fp8":
        # forward in fp8, gradient straight through
        x = x + (fp8_round(x, -1) - x).detach()
        w = w + (fp8_round(w, 0) - w).detach()
    return x @ w


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, T, heads, hd) at positions 0..T-1, rotated by halves."""
    T, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv = 1.0 / theta ** (torch.arange(half, device=x.device, dtype=torch.float32) / half)
    ang = torch.arange(T, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Softmax(q k^T / sqrt(hd)) v over positions at or before each query,
    q (B, T, H, hd), k/v (B, T, K, hd); query head h reads KV head
    h // (H / K).  Scores in blocks of ``ATTN_ROWS`` query rows."""
    B, T, H, hd = q.shape
    group = H // k.shape[2]
    k = k.repeat_interleave(group, dim=2).transpose(1, 2)     # (B, H, T, hd)
    v = v.repeat_interleave(group, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    outs = []
    for lo in range(0, T, ATTN_ROWS):
        hi = min(T, lo + ATTN_ROWS)
        s = (q[:, :, lo:hi] @ k[:, :, :hi].transpose(-1, -2)) / math.sqrt(hd)
        mask = (torch.arange(lo, hi, device=q.device)[:, None]
                < torch.arange(hi, device=q.device)[None, :])
        s = s.masked_fill(mask, float("-inf"))
        outs.append(torch.softmax(s, dim=-1) @ v[:, :, :hi])
    return torch.cat(outs, dim=2).transpose(1, 2)             # (B, T, H, hd)


def _f32(tensors: Weights) -> Weights:
    return {n: t.float() for n, t in tensors.items()}


@torch.no_grad()
def served_gaps(family, s, seed: int, seqs: Sequence[Tuple[List[int], List[int]]], device,
                control: bool = False) -> Dict[str, object]:
    """Teacher-forced check of served requests, each (prompt, served tokens):
    the reference runs once over prompt + served[:-1], layer by layer, and
    each served token's gap is the reference's best logit at its position
    less the reference's logit of that token.  Returns the widest gap, the
    number of tokens, and with ``control`` the widest gap of the token that
    the fp8 control puts first at each position."""
    with strict_f32():
        top_group, *blocks = family.groups(s)
        top = _f32(draw_group(family, s, seed, top_group, device))
        toks = [torch.tensor(p + o[:-1], device=device, dtype=torch.long) for p, o in seqs]
        hs = [family.embed(s, top, t)[None] for t in toks]
        cs = [h.clone() for h in hs] if control else []
        for i in blocks:
            W = _f32(draw_group(family, s, seed, i, device))
            hs = [family.block(s, W, i, h) for h in hs]
            cs = [family.block(s, W, i, h, "fp8") for h in cs]
            del W
        widest, ctrl_widest, n = 0.0, 0.0, 0
        for j, (prompt, out) in enumerate(seqs):
            at = slice(len(prompt) - 1, len(prompt) - 1 + len(out))
            ref = family.final_logits(s, top, hs[j][0, at])
            best = ref.max(dim=-1).values
            served = torch.tensor(out, device=device, dtype=torch.long)
            gap = best - ref.gather(1, served[:, None])[:, 0]
            widest = max(widest, float(gap.max()))
            n += len(out)
            if control:
                pick = family.final_logits(s, top, cs[j][0, at], "fp8").argmax(dim=-1)
                cgap = best - ref.gather(1, pick[:, None])[:, 0]
                ctrl_widest = max(ctrl_widest, float(cgap.max()))
    result = {"served_logit_gap": widest, "tokens": n}
    if control:
        result["control_logit_gap"] = ctrl_widest
    return result


def warmup_cosine(peak: float, warmup: int, total: int, floor: float, step: int) -> float:
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine decay
    to ``floor * peak`` at ``total`` (the recipe the training mix states)."""
    if step < warmup:
        return peak * step / max(warmup, 1)
    frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * frac)))


def decays(name: str, t: torch.Tensor) -> bool:
    """Weight decay falls on leaves of two or more dims, a block's leaf
    counting its layer index as one (the stacked layout the recipe names):
    every leaf but the final norm's weight."""
    return t.dim() + sum(part.isdigit() for part in name.split(".")) >= 2


class TrainReference:
    """The training step in float32 from the seeded weights: loss, global
    norm clip, AdamW with the mix's schedule.  Layers are recomputed in
    the backward pass (``checkpoint``) so that the activations of a long
    batch fit."""

    def __init__(self, family, s, seed: int, opt: Dict, device, quant: Optional[str] = None):
        self.family, self.s, self.opt, self.quant = family, s, opt, quant
        self.params: Weights = {}
        for g in family.groups(s):
            self.params.update(_f32(draw_group(family, s, seed, g, device)))
        for t in self.params.values():
            t.requires_grad_(True)
        self.m = {n: torch.zeros_like(t) for n, t in self.params.items()}
        self.v = {n: torch.zeros_like(t) for n, t in self.params.items()}
        self.step_no = 0

    def loss(self, tokens: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        h = self.family.embed(self.s, self.params, tokens.long())
        for i in self.family.groups(self.s)[1:]:
            h = checkpoint(self._layer, h, i, use_reentrant=False)
        B, T, _ = h.shape
        total = torch.zeros((), device=h.device)
        for lo in range(0, T, LOSS_CHUNK):
            total = total + checkpoint(self._chunk_loss, h[:, lo:lo + LOSS_CHUNK],
                                       labels[:, lo:lo + LOSS_CHUNK], use_reentrant=False)
        return total / (B * T)

    def _layer(self, h: torch.Tensor, i: int) -> torch.Tensor:
        return self.family.block(self.s, self.params, i, h, self.quant)

    def _chunk_loss(self, h: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        logits = self.family.final_logits(self.s, self.params, h, self.quant)
        return F.cross_entropy(logits.flatten(0, 1), labels.long().flatten(), reduction="sum")

    def step(self, tokens: torch.Tensor, labels: torch.Tensor
             ) -> Tuple[float, Dict[str, float]]:
        """One optimizer step; the loss and each leaf's norm of the clipped
        gradient the optimizer took."""
        o = self.opt
        names = list(self.params)
        with strict_f32():
            loss = self.loss(tokens, labels)
            grads = torch.autograd.grad(loss, [self.params[n] for n in names])
        with torch.no_grad():
            self.step_no += 1
            t = self.step_no
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.clamp(o["grad_clip"] / (gnorm + 1e-9), max=1.0)
            lr = warmup_cosine(o["lr"], o["warmup"], o["total_steps"], o["floor"], t)
            c1, c2 = 1 - o["b1"] ** t, 1 - o["b2"] ** t
            norms = {}
            for n, g in zip(names, grads):
                p = self.params[n]
                g = g * scale
                norms[n] = float(torch.linalg.vector_norm(g))
                self.m[n].mul_(o["b1"]).add_((1 - o["b1"]) * g)
                self.v[n].mul_(o["b2"]).add_((1 - o["b2"]) * g * g)
                delta = (self.m[n] / c1) / (torch.sqrt(self.v[n] / c2) + o["eps"])
                if o["weight_decay"] > 0 and decays(n, p):
                    delta = delta + o["weight_decay"] * p
                p.sub_(lr * delta)
        return float(loss.detach()), norms

    @torch.no_grad()
    def change_norms(self, seed: int, device) -> Dict[str, float]:
        """Each leaf's norm of its change from the seeded start."""
        out = {}
        for g in self.family.groups(self.s):
            start = draw_group(self.family, self.s, seed, g, device)
            for n in leaf_names(self.family, self.s, g):
                out[n] = float(torch.linalg.vector_norm(self.params[n] - start[n].float()))
        return out


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              skip: Callable[[str], bool] = lambda n: False) -> Dict[str, float]:
    """Each leaf's gap between two sets of per-leaf norms, against the
    reference's norm of that leaf or of the median leaf, whichever is
    larger."""
    names = [n for n in want if not skip(n)]
    ordered = sorted(want[n] for n in names)
    median = ordered[len(ordered) // 2]
    return {n: abs(got[n] - want[n]) / max(want[n], median, 1e-30) for n in names}
