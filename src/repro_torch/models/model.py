"""Model interface: config -> {init, apply, prefill, decode_step, init_cache}.

The port's counterpart of ``repro/models/model.py`` for the families it has
ported so far: the dense decoder, the MoE decoder and the Mamba2 hybrid.
Other families (``vlm`` included, which the JAX package runs on the dense
decoder) raise until their slice lands.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from types import ModuleType
from typing import Callable, Optional

from ..configs.base import ArchConfig, ShapeConfig

__all__ = ["ModelBundle", "PORTED_FAMILIES", "bundle_for", "model_module", "param_count",
           "memory_estimate"]

PORTED_FAMILIES = ("dense", "moe", "hybrid")


@dataclass(frozen=True)
class ModelBundle:
    family: str
    init: Callable
    apply: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def model_module(cfg: ArchConfig) -> ModuleType:
    """The module that runs ``cfg``'s family; its ``Model`` builds the
    parameter container."""
    if cfg.family == "dense":
        from . import transformer as m
    elif cfg.family == "moe":
        from . import moe as m
    elif cfg.family == "hybrid":
        from . import hybrid as m
    else:
        raise ValueError(f"family {cfg.family!r} is not ported yet; the PyTorch port "
                         f"runs {PORTED_FAMILIES}")
    return m


def bundle_for(cfg: ArchConfig) -> ModelBundle:
    m = model_module(cfg)
    return ModelBundle(cfg.family, m.init, m.apply, m.prefill, m.decode_step,
                       m.init_cache)


@functools.lru_cache(maxsize=64)
def _param_count(cfg: ArchConfig) -> int:
    model = model_module(cfg).Model(cfg, device="meta")
    return sum(math.prod(p.shape) for p in model.parameters())


def param_count(cfg: ArchConfig, active_only: bool = False) -> int:
    """Exact parameter count from the model's shapes (nothing allocated);
    ``active_only`` leaves out the experts a token is not routed to."""
    n = _param_count(cfg)
    if active_only and cfg.is_moe:
        n -= (cfg.n_experts - cfg.top_k) * 3 * cfg.d_model * cfg.d_ff * cfg.n_layers
    return n


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
        n_attn = cfg.n_layers if cfg.family != "hybrid" \
            else cfg.n_layers // cfg.attn_every
        if cfg.family == "ssm":
            kv, n_attn = 0, 0
        cache_bytes = 2.0 * kv * n_attn
    return (param_bytes + opt_bytes + act_bytes + cache_bytes) / max(chips, 1)
