"""Wrappers of the CUDA MoE router kernels (``csrc/moe_gating.cu``,
``csrc/moe_router_bwd.cu``).

``moe_gating`` replaces ``repro/kernels/moe_gating.py::moe_gating`` (Pallas
TPU): logits in, row softmax in f32, top-k with ties to the lowest expert
index, renormalised.  It takes any number of tokens (the Pallas kernel
asserts T % 256 == 0 past 256 tokens), up to 256 experts and k <= 32.

``moe_router`` replaces the same kernel with the router product in front of
it (``repro/models/moe.py:106``) and the softmax of the load-balance
statistics behind it: x and the f32 router in, weights, ids and the
probabilities out of one launch, the logits summed in f32.  It carries a
gradient: where autograd needs one, the call goes through the registered
op ``repro_torch::moe_router``, whose backward launches ``moe_router_bwd``
(the logits' gradient in closed form) and then the router's two f32
products.  ``moe_gating`` has no backward and refuses inputs that require
grad.

All run only on CUDA tensors; ``ops.moe_gating`` and ``ops.moe_router``
send CPU tensors to the plain versions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ._build import library
from .decode_attention import _sms
from .flash_attention import refuse_grad

__all__ = ["moe_gating", "moe_router", "moe_router_fwd", "moe_router_bwd", "router_plan",
           "MAX_EXPERTS", "MAX_K", "MAX_D"]

MAX_EXPERTS = 256   # eight register values per lane of the row's warp
MAX_K = 32          # lane j keeps the j-th winner
ROUTER_CHUNK = 32   # router rows per shared-memory stage (csrc KC)
MAX_CLUSTER = 16    # blocks splitting D (more than 8: a non-portable cluster)
DECODE_TOKENS = 8   # tokens the decode kernel takes (csrc DECODE_ROWS)
MAX_D = 8192        # the tile kernel's x slab, 80 rows of D/16 f32, fits


def moe_gating(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits: (T,E) f32, contiguous, on a CUDA device -> (weights (T,k) f32,
    ids (T,k) int32)."""
    refuse_grad("moe_gating", logits)
    if not logits.is_cuda:
        raise ValueError(f"logits must be a CUDA tensor, got {logits.device}")
    if logits.dim() != 2 or logits.dtype != torch.float32 or not logits.is_contiguous():
        raise ValueError(f"logits must be contiguous (T,E) f32, got {tuple(logits.shape)} "
                         f"{logits.dtype}")
    T, E = logits.shape
    _check_experts(T, E, k)
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


def _check_experts(T: int, E: int, k: int) -> None:
    if T < 1 or not 1 <= E <= MAX_EXPERTS:
        raise ValueError(f"need T >= 1 and 1 <= E <= {MAX_EXPERTS} experts, got T={T} E={E}")
    if not 1 <= k <= min(E, MAX_K):
        raise ValueError(f"need 1 <= k <= min(E, {MAX_K}), got k={k} for E={E}")


def router_plan(tokens: int, d_model: int, sms: int) -> Tuple[int, int]:
    """(token rows per cluster, blocks per cluster) of ``moe_router``; D is
    split over the cluster in runs of ROUTER_CHUNK rows.  Up to
    DECODE_TOKENS tokens take the decode kernel (rows 0) on one cluster of
    up to MAX_CLUSTER blocks: the router's read is spread over as many SMs
    as a cluster holds.  More take the tile kernel: clusters of 8 blocks,
    or up to 16 where D passes 8 runs of 8 chunks (its x slab must fit),
    and the most rows per cluster (80, then 16) that still give about three
    quarters of a block per SM, else 16."""
    chunks = -(-d_model // ROUTER_CHUNK)
    if tokens <= DECODE_TOKENS:
        return 0, min(MAX_CLUSTER, chunks)
    cluster = min(MAX_CLUSTER, max(min(8, chunks), -(-chunks // 8)))
    for rows in (80, 16):
        if -(-tokens // rows) * cluster >= 3 * sms // 4:
            return rows, cluster
    return 16, cluster


def moe_router_fwd(x: torch.Tensor, router: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of the router kernel, no autograd: x (T,D) bf16 or f32,
    router (D,E) f32, both contiguous on one CUDA device, D % 8 == 0 and
    D <= MAX_D -> (weights (T,k) f32, ids (T,k) int32, probabilities (T,E)
    f32) of the logits ``x.float() @ router``."""
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float32) \
            or not x.is_contiguous():
        raise ValueError(f"x must be contiguous (T,D) bf16 or f32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if router.device != x.device or router.dim() != 2 or router.dtype != torch.float32 \
            or not router.is_contiguous():
        raise ValueError(f"router must be contiguous (D,E) f32 on {x.device}, got "
                         f"{tuple(router.shape)} {router.dtype} on {router.device}")
    T, D = x.shape
    E = router.shape[1]
    if router.shape[0] != D or D % 8 or D > MAX_D:
        raise ValueError(f"x (T,D) = {tuple(x.shape)} and router {tuple(router.shape)} need "
                         f"equal D with D % 8 == 0 and D <= {MAX_D}")
    _check_experts(T, E, k)
    if x.data_ptr() % 16 or router.data_ptr() % 16:
        raise ValueError("x and router must start on a 16-byte boundary")
    dev = x.device
    w = torch.empty((T, k), dtype=torch.float32, device=dev)
    ids = torch.empty((T, k), dtype=torch.int32, device=dev)
    probs = torch.empty((T, E), dtype=torch.float32, device=dev)
    rows, cluster = router_plan(T, D, _sms(dev.index))
    err = library().moe_router_fwd(
        x.data_ptr(), int(x.dtype == torch.bfloat16), router.data_ptr(), w.data_ptr(),
        ids.data_ptr(), probs.data_ptr(), dev.index, T, D, E, k, rows, cluster,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"moe_router kernel launch failed: CUDA error {err}")
    moe_router.launches += 1
    return w, ids, probs


def _check_routed(name: str, t: torch.Tensor, shape, dtype, like: torch.Tensor) -> None:
    if (t.device != like.device or tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} {dtype} tensor on "
                         f"{like.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def moe_router_bwd(gw: torch.Tensor, gprobs: Optional[torch.Tensor], w: torch.Tensor,
                   ids: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """The gradient of the router's logits (T,E) f32 from the gradients of
    its weights ``gw`` (T,k) and probabilities ``gprobs`` (T,E) (None where
    nothing reads them) and the forward's ``w``, ``ids`` and ``probs``, all
    f32 (ids int32), contiguous, on one CUDA device: one launch of
    ``csrc/moe_router_bwd.cu``, the closed form of ``ref.moe_router_bwd_ref``."""
    if not probs.is_cuda:
        raise ValueError(f"probs must be a CUDA tensor, got {probs.device}")
    if probs.dim() != 2 or w.dim() != 2:
        raise ValueError(f"probs (T,E) and w (T,k) expected, got {tuple(probs.shape)} and "
                         f"{tuple(w.shape)}")
    T, E = probs.shape
    k = w.shape[1]
    _check_experts(T, E, k)
    _check_routed("probs", probs, (T, E), torch.float32, probs)
    _check_routed("w", w, (T, k), torch.float32, probs)
    _check_routed("gw", gw, (T, k), torch.float32, probs)
    _check_routed("ids", ids, (T, k), torch.int32, probs)
    if gprobs is not None:
        _check_routed("gprobs", gprobs, (T, E), torch.float32, probs)
    dlogits = torch.empty((T, E), dtype=torch.float32, device=probs.device)
    err = library().moe_router_bwd(
        gw.data_ptr(), None if gprobs is None else gprobs.data_ptr(), w.data_ptr(),
        ids.data_ptr(), probs.data_ptr(), dlogits.data_ptr(), probs.device.index, T, E, k,
        torch.cuda.current_stream(probs.device).cuda_stream)
    if err:
        raise RuntimeError(f"moe_router_bwd kernel launch failed: CUDA error {err}")
    moe_router_bwd.launches += 1
    return dlogits


moe_router_bwd.launches = 0   # kernel launches since the count was last reset


# The differentiable form, as ``flash_attention.py`` registers attention's:
# one op that autograd and torch.utils.checkpoint's selective policies see.
# It saves x, the router and the forward's outputs; its backward launches
# moe_router_bwd, then the router's two f32 products (the reference leaves
# them to XLA, outside the Pallas kernel).
@torch.library.custom_op("repro_torch::moe_router", mutates_args=(), device_types="cuda")
def _router_op(x: torch.Tensor, router: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return moe_router_fwd(x, router, k)


@_router_op.register_fake
def _(x, router, k):
    T, E = x.shape[0], router.shape[1]
    return (x.new_empty((T, k), dtype=torch.float32), x.new_empty((T, k), dtype=torch.int32),
            x.new_empty((T, E), dtype=torch.float32))


def _setup_context(ctx, inputs, output):
    x, router, _ = inputs
    w, ids, probs = output
    ctx.mark_non_differentiable(ids)
    ctx.set_materialize_grads(False)       # an unread output's gradient is None
    ctx.save_for_backward(x, router, w, ids, probs)


def _backward(ctx, gw, _gids, gprobs):
    x, router, w, ids, probs = ctx.saved_tensors
    if gw is None and gprobs is None:
        return None, None, None
    gw = torch.zeros_like(w) if gw is None else gw.float().contiguous()
    gprobs = None if gprobs is None else gprobs.float().contiguous()
    dlogits = moe_router_bwd(gw, gprobs, w, ids, probs)
    dx = (dlogits @ router.T).to(x.dtype) if ctx.needs_input_grad[0] else None
    drouter = x.float().T @ dlogits if ctx.needs_input_grad[1] else None
    return dx, drouter, None


_router_op.register_autograd(_backward, setup_context=_setup_context)


def moe_router(x: torch.Tensor, router: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (T,D) bf16 or f32, router: (D,E) f32 -> (weights (T,k) f32, ids
    (T,k) int32, probabilities (T,E) f32), as ``moe_router_fwd``.  Where
    autograd needs a gradient (grad mode on, x or the router requiring
    grad) the call goes through the registered op, whose backward is
    ``moe_router_bwd`` and the two products; otherwise (serving) one
    forward launch."""
    if torch.is_grad_enabled() and (x.requires_grad or router.requires_grad):
        return torch.ops.repro_torch.moe_router(x, router, k)
    return moe_router_fwd(x, router, k)


moe_router.launches = 0   # forward kernel launches since the count was last reset
