"""Seeded weights, made on the device in the served dtype.

A model's leaves come in groups, as its family's ``groups`` and ``leaves``
give them (the leaves outside the blocks, then one group a block).  Each
group is drawn by one ``torch.randn`` call from a generator seeded with the
run's seed and the group's index, cut into its leaves and scaled in place
by each leaf's ``init``.  The port's model and the plain reference both
take their weights from here, so drawing a group again gives the reference
the same tensors without reading anything the program made.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

__all__ = ["TOP", "group_seed", "norm", "embedding", "fan_in", "draw_group", "leaf_names"]

TOP = -1               # the group of the leaves outside the blocks
NORM_SPREAD = 0.1      # norm weights are 1 + 0.1 * normal
EMBED_STD = 0.02


def group_seed(seed: int, group: int) -> int:
    """A generator seed for one group of one run, below 2**63."""
    return (int(seed) * 1_000_003 + group + 1) % (2 ** 63)


def norm(t: torch.Tensor) -> None:
    """A norm's weight: 1 + 0.1 * normal."""
    t.mul_(NORM_SPREAD).add_(1.0)


def embedding(t: torch.Tensor) -> None:
    """An embedding table: 0.02 * normal."""
    t.mul_(EMBED_STD)


def fan_in(t: torch.Tensor) -> None:
    """A projection applied as ``x @ w``: normal / sqrt(fan_in)."""
    t.mul_(1.0 / math.sqrt(t.shape[0]))


def leaf_names(family, s, group: int) -> List[str]:
    """The full names of ``group``'s leaves."""
    return [name for name, _, _ in family.leaves(s, group)]


@torch.no_grad()
def draw_group(family, s, seed: int, group: int, device, dtype=None) -> Dict[str, torch.Tensor]:
    """The leaves of ``group`` (full names), drawn in one call in the
    served dtype and scaled in place by each leaf's ``init``."""
    dtype = dtype or getattr(torch, s.dtype)
    leaves = family.leaves(s, group)
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    gen = torch.Generator(device=device)
    gen.manual_seed(group_seed(seed, group))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    out, off = {}, 0
    for (name, shape, init), n in zip(leaves, sizes):
        t = flat[off:off + n].view(shape)
        off += n
        init(t)
        out[name] = t
    return out
