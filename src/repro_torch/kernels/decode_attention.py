"""Wrapper of the CUDA flash-decode kernel (``csrc/decode_attention.cu``).

It replaces ``repro/kernels/decode_attention.py::flash_decode`` (Pallas TPU)
and takes what the serving engine sends it: per-slot ``(B,)`` lengths (or
one scalar for the whole batch), read by the kernel from device memory, and
a cache of any ``Smax``.  The cache is read in place through its strides and
never copied.  In bf16 each (slot, KV head) gets ``decode_splits(...)``
blocks, one thread-block cluster, each of which takes an equal share of
that slot's own 64-position tiles; the cluster merges their partial softmax
sums in shared memory.  In f32 one block per 64-position chunk writes a
partial to scratch, and a second kernel combines them.  It runs only on
CUDA tensors; ``ops.decode_attention`` sends CPU tensors to the plain
version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Union

import torch

from ._build import library
from .flash_attention import _DTYPES, HEAD_DIMS, check_kernel_input, refuse_grad

__all__ = ["flash_decode", "decode_splits", "MAX_GROUP", "MAX_SPLITS", "TILE"]

MAX_GROUP = 8    # query heads per KV head the kernel takes
MAX_SPLITS = 4   # bf16 blocks per (slot, KV head): one cluster; larger ones measured slower
TILE = 64        # cache positions per tile (and per f32 block)


def decode_splits(batch: int, kv_heads: int, smax: int, sms: int) -> int:
    """Blocks per (slot, KV head) of the bf16 kernel: about one block per SM
    over the ``batch * kv_heads`` pairs, at least one, at most one per tile
    of ``smax`` and at most ``MAX_SPLITS``.  Once the pairs alone keep every
    SM streaming, more blocks only add the merge of their partial sums.  No
    length enters: each block reads its slot's length on the device and
    takes an equal share of that slot's tiles, so the host never waits and
    per-slot and scalar lengths launch the same grid."""
    return max(1, min(MAX_SPLITS, -(-smax // TILE), sms // (batch * kv_heads)))


@functools.lru_cache(maxsize=None)
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def flash_decode(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                 length: Union[int, torch.Tensor]) -> torch.Tensor:
    """q: (B,1,H,hd); cache_k/v: (B,Smax,K,hd); length: int, 0-dim or (B,)
    int tensor on q's device -> (B,1,H,hd) in q's dtype."""
    refuse_grad("flash_decode", q, cache_k, cache_v)
    if q.dim() != 4 or q.shape[1] != 1 or cache_k.dim() != 4 \
            or cache_v.shape != cache_k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} cache {tuple(cache_k.shape)} "
                         f"/ {tuple(cache_v.shape)}")
    B, _, H, hd = q.shape
    Smax, K = cache_k.shape[1], cache_k.shape[2]
    if cache_k.shape[0] != B or cache_k.shape[3] != hd or H % K:
        raise ValueError(f"q {tuple(q.shape)} does not match cache {tuple(cache_k.shape)}")
    if hd not in HEAD_DIMS or H // K > MAX_GROUP:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS} or group {H // K} > {MAX_GROUP}")
    for name, t in (("q", q), ("cache_k", cache_k), ("cache_v", cache_v)):
        check_kernel_input(name, t, q)
    if isinstance(length, torch.Tensor):
        if length.device != q.device or length.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"length must be an integer tensor on {q.device}")
        if length.numel() not in (1, B) or length.dim() > 1:
            raise ValueError(f"length of shape {tuple(length.shape)} for batch {B}")
        lengths = length.to(torch.int32).contiguous()
    else:
        lengths = torch.full((1,), int(length), dtype=torch.int32, device=q.device)
    o = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    if q.dtype == torch.bfloat16:
        splits, part = decode_splits(B, K, Smax, _sms(q.device.index)), None
    else:   # one block per tile of Smax, partials in scratch; `splits` unused
        splits = 1
        part = torch.empty(B * K * -(-Smax // TILE) * (H // K) * (hd + 2),
                           dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 10)(
        q.stride(0), q.stride(2), *cache_k.stride()[:3], *cache_v.stride()[:3],
        o.stride(0), o.stride(2))
    err = library().flash_decode_fwd(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), lengths.data_ptr(),
        1 if lengths.numel() == B and B > 1 else 0, o.data_ptr(), _DTYPES[q.dtype],
        q.device.index, B, Smax, H, K, hd, splits, strides, hd ** -0.5,
        None if part is None else part.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error {err}")
    flash_decode.launches += 1
    return o


flash_decode.launches = 0   # kernel launches since the count was last reset
