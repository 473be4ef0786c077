"""The models' one call site for attention, dispatched by tensor device.

A CUDA tensor goes to the hand-written kernel, which launches or raises; a
CPU tensor goes to the plain PyTorch version.  There is no switch that sends
a CUDA tensor to the plain version.
"""

from __future__ import annotations

from typing import Union

import torch

from . import ref
from .decode_attention import flash_decode
from .flash_attention import flash_attention

__all__ = ["attention", "decode_attention"]


def _unsupported(t: torch.Tensor) -> ValueError:
    return ValueError(f"no attention implementation for device {t.device}")


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
