"""The models' one call site for each kernel, dispatched by tensor device.

A CUDA tensor goes to the hand-written kernel, which launches or raises; a
CPU tensor goes to the plain PyTorch version, differentiated by autograd.
There is no switch that sends a CUDA tensor to the plain version.
``attention``, ``moe_router`` and ``ssd_state_scan`` carry gradients on the
card, each through its registered op and its backward kernel
(``flash_attention_bwd``, ``moe_router_bwd``, ``ssd_state_scan_bwd``);
``decode_attention`` and ``moe_gating`` have no backward and raise where
autograd would need one.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from . import ref
from .decode_attention import flash_decode
from .flash_attention import flash_attention
from .moe_gating import moe_gating as _moe_gating_kernel
from .moe_gating import moe_router as _moe_router_kernel
from .ssd_scan import ssd_state_scan as _ssd_scan_kernel

__all__ = ["attention", "decode_attention", "moe_gating", "moe_router", "ssd_state_scan"]


def _unsupported(t: torch.Tensor) -> ValueError:
    return ValueError(f"no kernel implementation for device {t.device}")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    if q.is_cuda:
        return flash_attention(q, k, v, causal=causal)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal)
    raise _unsupported(q)


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                     length: Union[int, torch.Tensor]) -> torch.Tensor:
    if q.is_cuda:
        return flash_decode(q, cache_k, cache_v, length)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, cache_k, cache_v, length)
    raise _unsupported(q)


def moe_gating(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    if logits.is_cuda:
        return _moe_gating_kernel(logits, k)
    if logits.device.type == "cpu":
        return ref.moe_gating_ref(logits, k)
    raise _unsupported(logits)


def moe_router(x: torch.Tensor, router: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if x.is_cuda:
        return _moe_router_kernel(x, router, k)
    if x.device.type == "cpu":
        return ref.moe_router_ref(x, router, k)
    raise _unsupported(x)


def ssd_state_scan(chunk_states: torch.Tensor, chunk_decays: torch.Tensor,
                   init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    if chunk_states.is_cuda:
        return _ssd_scan_kernel(chunk_states, chunk_decays, init_state)
    if chunk_states.device.type == "cpu":
        return ref.ssd_state_scan_ref(chunk_states, chunk_decays, init_state)
    raise _unsupported(chunk_states)
