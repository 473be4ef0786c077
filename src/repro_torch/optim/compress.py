"""Cross-pod gradient compression, ported from ``repro/optim/compress.py``.

On a multi-pod mesh the inter-pod links are the scarce resource.  The
cross-pod gradient all-reduce is compressed to int8 with per-tensor
scales: each pod quantizes its gradient, the int8 shards go round by one
``all_to_all``, each pod sums the shards it owns in f32 (each dequantized
with its sender's scale), re-quantizes the partial sum, and one
``all_gather`` of int8 hands every pod the whole.  Every element crosses
the pod links twice as one byte instead of four.  Off unless a train step
asks for it (``train.step.make_train_step(compress_pods=True)``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from ..collectives import all_gather, all_to_all

__all__ = ["compressed_psum_pod", "compress_grads_with_feedback"]

def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, the per-tensor scale max|x| / 127), in x's dtype as the
    reference computes them."""
    scale = torch.clamp_min(torch.max(torch.abs(x)), 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum_pod(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (the pods), with int8 on
    the wire: reduce-scatter (an ``all_to_all`` of int8 shards and a local
    f32 sum), then an ``all_gather`` of the int8 result.  The flat tensor is
    padded to a multiple of the pod count.  With one pod, ``x`` itself."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    q, scale = _quantize(flat)
    # every pod needs every scale to dequantize partial sums consistently
    scales = all_gather(scale.reshape(1), group)[:, 0]              # (n,)
    recv = all_to_all(q.reshape(n, -1), group)                      # (n, chunk) int8
    # each pod's shard dequantized with its own scale, summed locally
    part = torch.sum(recv.float() * scales[:, None], dim=0)
    # the partial sum re-quantized and gathered from all pods
    q2, s2 = _quantize(part)
    all_s2 = all_gather(s2.reshape(1), group)                       # (n, 1)
    all_q2 = all_gather(q2, group)                                  # (n, chunk) int8
    full = (all_q2.float() * all_s2).reshape(-1)
    if pad:
        full = full[:-pad]
    return full.reshape(x.shape).to(x.dtype)


def compress_grads_with_feedback(grads: List[torch.Tensor],
                                 error: Optional[List[torch.Tensor]]
                                 ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Per-tensor int8 quantization with error feedback: returns (the
    quantized-dequantized gradients, the new error buffers).  The error
    carried into the next step is the f32 remainder of (gradient + old
    error) after quantization; None starts it at zero."""
    if error is None:
        error = [torch.zeros(g.shape, dtype=torch.float32, device=g.device) for g in grads]
    deq, new_err = [], []
    for g, e in zip(grads, error):
        corrected = g.float() + e
        q, scale = _quantize(corrected)
        d = q.float() * scale
        deq.append(d.to(g.dtype))
        new_err.append(corrected - d)
    return deq, new_err
