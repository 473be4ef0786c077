"""Wrapper of the CUDA SSD state-scan kernel (``csrc/ssd_scan.cu``).

It replaces ``repro/kernels/ssd_scan.py::ssd_state_scan`` (Pallas TPU), the
Mamba2 inter-chunk recurrence ``prefix[c] = s; s = a[c] * s + x[c]``, in
f32 only.  It runs only on CUDA tensors; ``ops.ssd_state_scan`` sends CPU
tensors to the plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ._build import library
from .flash_attention import refuse_grad

__all__ = ["ssd_state_scan"]


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} has dtype {t.dtype}; the kernel takes f32 only")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous of shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def ssd_state_scan(chunk_states: torch.Tensor, chunk_decays: torch.Tensor,
                   init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """chunk_states: (B,C,H,P,N); chunk_decays: (B,C,H); init_state:
    (B,H,P,N) or None (zeros) -> (prefix (B,C,H,P,N), final (B,H,P,N))."""
    refuse_grad("ssd_state_scan", chunk_states, chunk_decays, init_state)
    if chunk_states.dim() != 5:
        raise ValueError(f"chunk_states must be (B,C,H,P,N), got {tuple(chunk_states.shape)}")
    B, C, H, P, N = chunk_states.shape
    dev = chunk_states.device
    _check("chunk_states", chunk_states, (B, C, H, P, N), dev)
    _check("chunk_decays", chunk_decays, (B, C, H), dev)
    if init_state is not None:
        _check("init_state", init_state, (B, H, P, N), dev)
    prefix = torch.empty_like(chunk_states)
    final = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    err = library().ssd_scan_fwd(
        chunk_states.data_ptr(), chunk_decays.data_ptr(),
        None if init_state is None else init_state.data_ptr(), prefix.data_ptr(),
        final.data_ptr(), dev.index, B, C, H, P, N, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_state_scan kernel launch failed: CUDA error {err}")
    ssd_state_scan.launches += 1
    return prefix, final


ssd_state_scan.launches = 0   # kernel launches since the count was last reset
