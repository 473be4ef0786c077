"""The system under test, as the benchmark builds it: the port's model
for a configuration's ``ArchConfig`` (its family's ``arch_config``),
holding the seeded weights of ``weights.draw_group``.

This module and the families' ``arch_config`` and ``planted`` are where
the benchmark imports the port (``repro_torch``); the drivers reach the
port through them and through the entry points they call
(``ServeEngine``, ``make_train_step``).
"""

from __future__ import annotations

import torch
from torch import nn

from .weights import draw_group

__all__ = ["load_model"]


@torch.no_grad()
def load_model(family, arch, s, seed: int, device, requires_grad: bool = False) -> nn.Module:
    """The port's model (``models.model.model_module(arch).Model``) built
    without storage and given the seeded weights, group by group."""
    from repro_torch.models.model import model_module
    model = model_module(arch).Model(arch, device="meta", dtype=getattr(torch, s.dtype))
    modules = dict(model.named_modules())
    for g in family.groups(s):
        for name, t in draw_group(family, s, seed, g, device).items():
            owner, leaf = name.rsplit(".", 1)
            setattr(modules[owner], leaf, nn.Parameter(t, requires_grad=requires_grad))
    left = [n for n, p in model.named_parameters() if p.is_meta]
    if left:
        raise RuntimeError(f"leaves without weights: {left[:4]}")
    return model
