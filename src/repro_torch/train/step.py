"""Serve steps over a model bundle, ported from the serve half of
``repro/train/step.py`` (``make_prefill``, ``make_serve_step``): the entry
point through which the JAX package serves the families its
``ServeEngine`` does not take (MoE, hybrid).  The training half lands with
the training slice; the encoder-decoder input form with its family.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..configs.base import ArchConfig
from ..models.model import bundle_for

__all__ = ["make_prefill", "make_serve_step"]


def make_prefill(cfg: ArchConfig) -> Callable:
    """``prefill(params, {"tokens": (B, S)}, max_seq=None)`` -> (last-position
    logits (B, 1, V), cache)."""
    bundle = bundle_for(cfg)

    def prefill(params, inputs: Dict[str, torch.Tensor], max_seq: Optional[int] = None):
        return bundle.prefill(cfg, params, inputs["tokens"], max_seq=max_seq)

    return prefill


def make_serve_step(cfg: ArchConfig) -> Callable:
    """``serve_step(params, cache, tokens (B, 1))`` -> (logits (B, 1, V),
    cache)."""
    bundle = bundle_for(cfg)

    def serve_step(params, cache, tokens: torch.Tensor):
        return bundle.decode_step(cfg, params, cache, tokens)

    return serve_step
