"""Seeded weights and inputs, made on the device in the served dtype.

Each group of parameters (the embedding and head, then one group a layer)
is drawn by one ``torch.randn`` call from a generator seeded with the run's
seed and the group's index, and cut into its leaves.  The port's model and
the plain reference both take their weights from here, so drawing a group
again gives the reference the same tensors without reading anything the
program made.  The leaves are named and laid out as the port's
``Transformer`` names them: ``(d_in, d_out)`` matrices applied as
``x @ w``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from .yardstick import Spec

__all__ = ["group_seed", "layer_leaves", "top_leaves", "draw_group", "groups",
           "leaf_names"]

NORM_SPREAD = 0.1      # norm weights are 1 + 0.1 * normal
EMBED_STD = 0.02


def group_seed(seed: int, group: int) -> int:
    """A generator seed for one group of one run, below 2**63."""
    return (int(seed) * 1_000_003 + group + 1) % (2 ** 63)


def layer_leaves(s: Spec) -> List[Tuple[str, Tuple[int, ...]]]:
    """One block's leaves, as ``blocks.<i>.`` names them."""
    D, H, K, hd, F = s.d_model, s.heads, s.kv_heads, s.head_dim, s.d_ff
    leaves = [("norm1.w", (D,)), ("attn.wq", (D, H * hd)), ("attn.wk", (D, K * hd)),
              ("attn.wv", (D, K * hd)), ("attn.wo", (H * hd, D))]
    if s.qk_norm:
        leaves += [("attn.q_norm", (hd,)), ("attn.k_norm", (hd,))]
    return leaves + [("norm2.w", (D,)), ("mlp.w_gate", (D, F)), ("mlp.w_up", (D, F)),
                     ("mlp.w_down", (F, D))]


def top_leaves(s: Spec) -> List[Tuple[str, Tuple[int, ...]]]:
    """The leaves outside the blocks."""
    leaves = [("embed.table", (s.vocab, s.d_model)), ("final_norm.w", (s.d_model,))]
    if not s.tied:
        leaves.append(("lm_head.w", (s.d_model, s.vocab)))
    return leaves


def groups(s: Spec) -> List[int]:
    """Group -1 is the embedding, final norm and head; 0.. are the layers."""
    return [-1] + list(range(s.layers))


def leaf_names(s: Spec, group: int) -> List[str]:
    if group < 0:
        return [n for n, _ in top_leaves(s)]
    return [f"blocks.{group}.{n}" for n, _ in layer_leaves(s)]


@torch.no_grad()
def draw_group(s: Spec, seed: int, group: int, device, dtype=None) -> Dict[str, torch.Tensor]:
    """The leaves of ``group`` (full names), drawn in one call in the
    served dtype and scaled in place: projections by 1 / sqrt(fan_in),
    the embedding by 0.02, norms to 1 + 0.1 * normal."""
    dtype = dtype or getattr(torch, s.dtype)
    leaves = top_leaves(s) if group < 0 else layer_leaves(s)
    sizes = [math.prod(shape) for _, shape in leaves]
    gen = torch.Generator(device=device)
    gen.manual_seed(group_seed(seed, group))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    out, off = {}, 0
    for (name, shape), n in zip(leaves, sizes):
        t = flat[off:off + n].view(shape)
        off += n
        if len(shape) == 1:
            t.mul_(NORM_SPREAD).add_(1.0)
        elif name == "embed.table":
            t.mul_(EMBED_STD)
        else:
            t.mul_(1.0 / math.sqrt(shape[0]))
        full = name if group < 0 else f"blocks.{group}.{name}"
        out[full] = t
    return out
