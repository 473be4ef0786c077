"""Model interface: config -> {init, apply, prefill, decode_step, init_cache}.

The port's counterpart of ``repro/models/model.py`` for the families it has
ported so far: the dense decoder.  Other families (``vlm`` included, which
the JAX package runs on the same decoder) raise until their slice lands.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Optional

from ..configs.base import ArchConfig, ShapeConfig

__all__ = ["ModelBundle", "bundle_for", "param_count", "memory_estimate"]

DENSE_FAMILIES = ("dense",)


@dataclass(frozen=True)
class ModelBundle:
    family: str
    init: Callable
    apply: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def bundle_for(cfg: ArchConfig) -> ModelBundle:
    if cfg.family not in DENSE_FAMILIES:
        raise ValueError(f"family {cfg.family!r} is not ported yet; the PyTorch port "
                         f"runs {DENSE_FAMILIES}")
    from . import transformer as m
    return ModelBundle("dense", m.init, m.apply, m.prefill, m.decode_step,
                       m.init_cache)


@functools.lru_cache(maxsize=64)
def param_count(cfg: ArchConfig) -> int:
    """Exact parameter count from the model's shapes (nothing allocated)."""
    bundle_for(cfg)
    from .transformer import param_shapes
    return sum(math.prod(s) for s in param_shapes(cfg).values())


def memory_estimate(cfg: ArchConfig, shape: ShapeConfig, chips: int,
                    train: Optional[bool] = None) -> float:
    """Bytes/chip estimate for admission (coarse, fp32 optimizer state)."""
    N = param_count(cfg)
    train = shape.kind == "train" if train is None else train
    param_bytes = 2 * N
    opt_bytes = 8 * N if train else 0
    act_bytes = 0.0
    if train:
        # full-remat floor: one (B,S,D) residual per layer in bf16
        act_bytes = 2.0 * shape.global_batch * shape.seq_len * cfg.d_model \
            * cfg.n_layers
    cache_bytes = 0.0
    if shape.kind == "decode":
        kv = 2 * cfg.n_kv_heads * cfg.hd * shape.seq_len * shape.global_batch
        cache_bytes = 2.0 * kv * cfg.n_layers
    return (param_bytes + opt_bytes + act_bytes + cache_bytes) / max(chips, 1)
