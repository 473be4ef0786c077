"""Wrapper of the CUDA MoE router kernel (``csrc/moe_gating.cu``).

It replaces ``repro/kernels/moe_gating.py::moe_gating`` (Pallas TPU): row
softmax in f32, top-k with ties to the lowest expert index, renormalised.
It takes any number of tokens (the Pallas kernel asserts T % 256 == 0 past
256 tokens), up to 256 experts and k <= 32.  It runs only on CUDA tensors;
``ops.moe_gating`` sends CPU tensors to the plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ._build import library

__all__ = ["moe_gating", "MAX_EXPERTS", "MAX_K"]

MAX_EXPERTS = 256   # eight register values per lane of the row's warp
MAX_K = 32          # lane j keeps the j-th winner


def moe_gating(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits: (T,E) f32, contiguous, on a CUDA device -> (weights (T,k) f32,
    ids (T,k) int32)."""
    if not logits.is_cuda:
        raise ValueError(f"logits must be a CUDA tensor, got {logits.device}")
    if logits.dim() != 2 or logits.dtype != torch.float32 or not logits.is_contiguous():
        raise ValueError(f"logits must be contiguous (T,E) f32, got {tuple(logits.shape)} "
                         f"{logits.dtype}")
    T, E = logits.shape
    if T < 1 or not 1 <= E <= MAX_EXPERTS:
        raise ValueError(f"need T >= 1 and 1 <= E <= {MAX_EXPERTS} experts, got T={T} E={E}")
    if not 1 <= k <= min(E, MAX_K):
        raise ValueError(f"need 1 <= k <= min(E, {MAX_K}), got k={k} for E={E}")
    w = torch.empty((T, k), dtype=torch.float32, device=logits.device)
    ids = torch.empty((T, k), dtype=torch.int32, device=logits.device)
    err = library().moe_gating_fwd(
        logits.data_ptr(), w.data_ptr(), ids.data_ptr(), logits.device.index, T, E, k,
        torch.cuda.current_stream(logits.device).cuda_stream)
    if err:
        raise RuntimeError(f"moe_gating kernel launch failed: CUDA error {err}")
    moe_gating.launches += 1
    return w, ids


moe_gating.launches = 0   # kernel launches since the count was last reset
