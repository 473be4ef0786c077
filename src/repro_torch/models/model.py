"""Model interface: config -> {init, loss_fn, apply, prefill, decode_step,
init_cache}, the input specs of a cell, and its analytic FLOPs.

The port's counterpart of ``repro/models/model.py`` for all six families:
the dense decoder, which also runs the ``vlm`` family (the early-fusion
backbone, as the JAX package runs it), the MoE decoder, the Mamba2 hybrid,
the xLSTM (``ssm``) and the encoder-decoder (``encdec``), all of which
serve and train.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from types import ModuleType
from typing import Any, Callable, Dict, Optional

import torch

from .. import resolve_device
from ..configs.base import ArchConfig, ShapeConfig

__all__ = ["ModelBundle", "PORTED_FAMILIES", "TRAINED_FAMILIES", "bundle_for",
           "model_module", "param_count", "memory_estimate", "input_specs", "synth_batch",
           "model_flops"]

PORTED_FAMILIES = ("dense", "vlm", "moe", "hybrid", "ssm", "encdec")
TRAINED_FAMILIES = ("dense", "vlm", "moe", "hybrid", "ssm", "encdec")


@dataclass(frozen=True)
class ModelBundle:
    family: str
    init: Callable
    loss_fn: Callable
    apply: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def model_module(cfg: ArchConfig) -> ModuleType:
    """The module that runs ``cfg``'s family; its ``Model`` builds the
    parameter container."""
    if cfg.family in ("dense", "vlm"):
        from . import transformer as m
    elif cfg.family == "moe":
        from . import moe as m
    elif cfg.family == "hybrid":
        from . import hybrid as m
    elif cfg.family == "ssm":
        from . import xlstm as m
    elif cfg.family == "encdec":
        from . import encdec as m
    else:
        raise ValueError(f"family {cfg.family!r} is not ported yet; the PyTorch port "
                         f"runs {PORTED_FAMILIES}")
    return m


def bundle_for(cfg: ArchConfig) -> ModelBundle:
    """The family's functions; a vlm config gets the dense bundle (named
    "dense", as the reference names it)."""
    m = model_module(cfg)
    family = "dense" if cfg.family == "vlm" else cfg.family
    return ModelBundle(family, m.init, m.loss_fn, m.apply, m.prefill, m.decode_step,
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


# ---------------------------------------------------------------------------
# input specs: meta tensors (shape and dtype, no storage), the port's
# counterpart of the reference's ShapeDtypeStructs
# ---------------------------------------------------------------------------

def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Every model input of this (arch, shape) cell as a meta tensor: token
    and label batches (train), the prompt batch (prefill), or one new token
    and the whole cache at ``seq_len`` (decode).  The encoder-decoder also
    takes the frontend stub's frame embeddings (B, S, D) in the config's
    dtype; its prompt is the frames and one token a sequence, its decode
    cache holds ``seq_len`` encoder positions (``init_cache``'s default)."""
    m = model_module(cfg)
    B, S = shape.global_batch, shape.seq_len
    frames = _spec((B, S, cfg.d_model), getattr(torch, cfg.dtype))
    encdec = cfg.family == "encdec"
    if shape.kind == "train":
        specs = {"tokens": _spec((B, S), torch.int32), "labels": _spec((B, S), torch.int32)}
        return {**specs, "frames": frames} if encdec else specs
    if shape.kind == "prefill":
        if encdec:
            return {"frames": frames, "tokens": _spec((B, 1), torch.int32)}
        return {"tokens": _spec((B, S), torch.int32)}
    if shape.kind == "decode":
        return {"tokens": _spec((B, 1), torch.int32),
                "cache": m.init_cache(cfg, B, S, device="meta")}
    raise ValueError(shape.kind)


def synth_batch(cfg: ArchConfig, shape: ShapeConfig, seed: int = 0, *,
                device=None) -> Dict[str, Any]:
    """Real (small!) tensors matching ``input_specs``, for smoke tests: token
    ids uniform in the vocab from a ``torch.Generator`` seeded with
    ``seed`` (the reference draws from a JAX key, so the values differ),
    frames normal, a fresh cache."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    out: Dict[str, Any] = {}
    for name, spec in input_specs(cfg, shape).items():
        if name == "cache":
            out[name] = model_module(cfg).init_cache(cfg, shape.global_batch, shape.seq_len,
                                                     device=device)
        elif spec.dtype.is_floating_point:
            out[name] = torch.randn(spec.shape, generator=gen).to(spec.dtype).to(device)
        else:
            out[name] = torch.randint(0, cfg.vocab, spec.shape, generator=gen,
                                      dtype=spec.dtype).to(device)
    return out


# ---------------------------------------------------------------------------
# analytic model FLOPs (the utilization ratio's numerator)
# ---------------------------------------------------------------------------

def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference forward), N the active
    parameters, D the tokens processed, plus the quadratic attention term
    where the family has one (the reference's formula)."""
    N = param_count(cfg, active_only=True)
    hd, H, Lc = cfg.hd, cfg.n_heads, cfg.n_layers
    B, S = shape.global_batch, shape.seq_len
    n_attn = {"dense": Lc, "vlm": Lc, "moe": Lc, "encdec": Lc,
              "hybrid": Lc // cfg.attn_every if cfg.attn_every else 0}.get(cfg.family, 0)
    if shape.kind == "train":
        # causal QK^T + PV, forward and backward (12 = 2 products * 2 flops * 3)
        return 6.0 * N * shape.tokens + 12.0 * n_attn * B * H * hd * S ** 2 / 2
    if shape.kind == "prefill":
        return 2.0 * N * shape.tokens + 4.0 * n_attn * B * H * hd * S ** 2 / 2
    # decode: one token per sequence and attention against the cache
    return 2.0 * N * B + 4.0 * n_attn * B * H * hd * S


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
