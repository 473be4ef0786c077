"""The system under test, as the benchmark builds it: the port's
``ArchConfig`` from a configuration file, and the port's ``Transformer``
holding the seeded weights of ``weights.draw_group``.

This is the one module of the benchmark that imports the port
(``repro_torch``); the drivers reach the port through it and through the
entry points they call (``ServeEngine``, ``make_train_step``).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from .weights import draw_group, groups
from .yardstick import Spec

__all__ = ["arch_config", "load_model"]


def arch_config(cfg: Dict, s: Spec, name: str):
    """The port's configuration record for the file's model, every size
    and constant taken from the file."""
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(arch_id=name, family="dense", n_layers=s.layers, d_model=s.d_model,
                      n_heads=s.heads, n_kv_heads=s.kv_heads, d_ff=s.d_ff, vocab=s.vocab,
                      head_dim=s.head_dim, qk_norm=s.qk_norm,
                      qkv_bias=bool(cfg.get("attention_bias", False)), rope_theta=s.theta,
                      tie_embeddings=s.tied, dtype=s.dtype, norm_eps=s.eps,
                      source=cfg["source"])


@torch.no_grad()
def load_model(arch, s: Spec, seed: int, device, requires_grad: bool = False) -> nn.Module:
    """The port's model (``models.model.model_module(arch).Model``) built
    without storage and given the seeded weights, group by group."""
    from repro_torch.models.model import model_module
    model = model_module(arch).Model(arch, device="meta", dtype=getattr(torch, s.dtype))
    modules = dict(model.named_modules())
    for g in groups(s):
        for name, t in draw_group(s, seed, g, device).items():
            owner, leaf = name.rsplit(".", 1)
            setattr(modules[owner], leaf, nn.Parameter(t, requires_grad=requires_grad))
    left = [n for n, p in model.named_parameters() if p.is_meta]
    if left:
        raise RuntimeError(f"leaves without weights: {left[:4]}")
    return model
