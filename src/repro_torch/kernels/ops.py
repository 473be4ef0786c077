"""The models' one call site for each kernel, dispatched by tensor device.

A CUDA tensor goes to the hand-written kernel, which launches or raises; a
CPU tensor goes to the plain PyTorch version, differentiated by autograd.
There is no switch that sends a CUDA tensor to the plain version.  A meta
tensor (shape and dtype, no storage: the dry run's) takes the CUDA path,
whose registered ops give their outputs' shapes and launch nothing.  A
DTensor goes to ``kernels/sharded.py``, which runs the same dispatch on
each rank's shards.
``attention``, ``moe_router`` and ``ssd_state_scan`` carry gradients on the
card, each through its registered op and its backward kernel
(``flash_attention_bwd``, ``moe_router_bwd``, ``ssd_state_scan_bwd``);
``decode_attention`` and ``moe_gating`` have no backward and raise where
autograd would need one.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..models.sharding import is_dtensor
from . import ref, sharded
from .decode_attention import flash_decode
from .flash_attention import flash_attention
from .moe_gating import moe_gating as _moe_gating_kernel
from .moe_gating import moe_router as _moe_router_kernel
from .ssd_scan import ssd_state_scan as _ssd_scan_kernel

__all__ = ["attention", "decode_attention", "decode_attention_lse", "moe_gating", "moe_router",
           "ssd_state_scan"]


def _unsupported(t: torch.Tensor) -> ValueError:
    return ValueError(f"no kernel implementation for device {t.device}")


def _kernel(t: torch.Tensor) -> bool:
    return t.is_cuda or t.is_meta


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    if is_dtensor(q):
        return sharded.attention(q, k, v, causal)
    if _kernel(q):
        return flash_attention(q, k, v, causal=causal)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal)
    raise _unsupported(q)


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                     length: Union[int, torch.Tensor]) -> torch.Tensor:
    if is_dtensor(q):
        return sharded.decode_attention(q, cache_k, cache_v, length)
    if _kernel(q):
        return flash_decode(q, cache_k, cache_v, length)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, cache_k, cache_v, length)
    raise _unsupported(q)


def decode_attention_lse(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                         length: Union[int, torch.Tensor]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``decode_attention`` on plain tensors, and the (B,H) f32 log-sum-exp
    of each query head's scores (``kernels/sharded.py`` merges a cache
    split over its positions with it)."""
    if _kernel(q):
        return flash_decode(q, cache_k, cache_v, length, with_lse=True)
    if q.device.type == "cpu":
        return (ref.decode_attention_ref(q, cache_k, cache_v, length),
                ref.decode_lse_ref(q, cache_k, length))
    raise _unsupported(q)


def moe_gating(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    if logits.is_cuda:
        return _moe_gating_kernel(logits, k)
    if logits.device.type == "cpu":
        return ref.moe_gating_ref(logits, k)
    raise _unsupported(logits)


def moe_router(x: torch.Tensor, router: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if _kernel(x):
        return _moe_router_kernel(x, router, k)
    if x.device.type == "cpu":
        return ref.moe_router_ref(x, router, k)
    raise _unsupported(x)


def ssd_state_scan(chunk_states: torch.Tensor, chunk_decays: torch.Tensor,
                   init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    if is_dtensor(chunk_states):
        return sharded.ssd_state_scan(chunk_states, chunk_decays, init_state)
    if _kernel(chunk_states):
        return _ssd_scan_kernel(chunk_states, chunk_decays, init_state)
    if chunk_states.device.type == "cpu":
        return ref.ssd_state_scan_ref(chunk_states, chunk_decays, init_state)
    raise _unsupported(chunk_states)
