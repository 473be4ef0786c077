"""Wrappers of the CUDA SSD state-scan kernels (``csrc/ssd_scan.cu``,
``csrc/ssd_scan_bwd.cu``).

``ssd_state_scan`` replaces ``repro/kernels/ssd_scan.py::ssd_state_scan``
(Pallas TPU), the Mamba2 inter-chunk recurrence ``prefix[c] = s; s = a[c] *
s + x[c]``, in f32 only.  It carries a gradient: where autograd needs one,
the call goes through the registered op ``repro_torch::ssd_state_scan``,
whose backward launches ``ssd_state_scan_bwd`` (the reverse walk in closed
form, from the forward's saved ``prefix``).  The reference has no Pallas
backward: it differentiates its oracle with XLA.

Both launches are registered ops (``repro_torch::ssd_state_scan``,
``repro_torch::ssd_state_scan_bwd``), whose fake implementations give the
outputs' shapes: a meta tensor (the dry run's ``launch/dryrun.py``) takes
the same ops as a CUDA tensor and launches nothing.
``ops.ssd_state_scan`` sends CPU tensors to the plain version.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ._build import library

__all__ = ["ssd_state_scan", "ssd_state_scan_fwd", "ssd_state_scan_bwd"]


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} has dtype {t.dtype}; the kernel takes f32 only")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous of shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def _dims(states: torch.Tensor) -> Tuple[int, int, int, int, int]:
    if states.dim() != 5:
        raise ValueError(f"expected (B,C,H,P,N), got {tuple(states.shape)}")
    return tuple(states.shape)


def ssd_state_scan_fwd(chunk_states: torch.Tensor, chunk_decays: torch.Tensor,
                       init_state: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the forward kernel, no autograd: chunk_states
    (B,C,H,P,N), chunk_decays (B,C,H), init_state (B,H,P,N) or None (zeros),
    all f32, contiguous, on one CUDA device -> (prefix (B,C,H,P,N), final
    (B,H,P,N))."""
    B, C, H, P, N = _dims(chunk_states)
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


def _bwd_launch(g_prefix: torch.Tensor, g_final: Optional[torch.Tensor],
                prefix: torch.Tensor, chunk_decays: torch.Tensor, has_init: bool
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    B, C, H, P, N = _dims(prefix)
    dev = prefix.device
    _check("prefix", prefix, (B, C, H, P, N), dev)
    _check("g_prefix", g_prefix, (B, C, H, P, N), dev)
    _check("chunk_decays", chunk_decays, (B, C, H), dev)
    if g_final is not None:
        _check("g_final", g_final, (B, H, P, N), dev)
    d_states = torch.empty_like(prefix)
    d_decays = torch.empty((B, C, H), dtype=torch.float32, device=dev)
    d_init = torch.empty((B, H, P, N), dtype=torch.float32, device=dev) if has_init else None
    err = library().ssd_scan_bwd(
        g_prefix.data_ptr(), None if g_final is None else g_final.data_ptr(),
        prefix.data_ptr(), chunk_decays.data_ptr(), d_states.data_ptr(), d_decays.data_ptr(),
        None if d_init is None else d_init.data_ptr(), dev.index, B, C, H, P, N,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_state_scan_bwd kernel launch failed: CUDA error {err}")
    ssd_state_scan_bwd.launches += 1
    return d_states, d_decays, d_init


@torch.library.custom_op("repro_torch::ssd_state_scan_bwd", mutates_args=(),
                         device_types=("cuda", "cpu"))
def _bwd_op(g_prefix: torch.Tensor, g_final: Optional[torch.Tensor], prefix: torch.Tensor,
            chunk_decays: torch.Tensor, has_init: bool) -> List[torch.Tensor]:
    # an op returns no optional tensor: d_init is a third entry, or none
    return [t for t in _bwd_launch(g_prefix, g_final, prefix, chunk_decays, has_init)
            if t is not None]


@_bwd_op.register_fake
def _(g_prefix, g_final, prefix, chunk_decays, has_init):
    B, C, H, P, N = _dims(prefix)
    out = [prefix.new_empty(prefix.shape), prefix.new_empty((B, C, H))]
    return out + [prefix.new_empty((B, H, P, N))] if has_init else out


def ssd_state_scan_bwd(g_prefix: torch.Tensor, g_final: Optional[torch.Tensor],
                       prefix: torch.Tensor, chunk_decays: torch.Tensor, has_init: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The gradient of the scan's inputs from the gradients of its outputs,
    ``g_prefix`` (B,C,H,P,N) and ``g_final`` (B,H,P,N) (None where nothing
    reads the final state), and the forward's ``prefix`` and decays (B,C,H),
    all f32, contiguous, on one CUDA device: one launch of
    ``csrc/ssd_scan_bwd.cu``, the closed form of ``ref.ssd_state_scan_bwd_ref``.
    Returns (d_states, d_decays, d_init, or None without ``has_init``)."""
    d_states, d_decays, *d_init = torch.ops.repro_torch.ssd_state_scan_bwd(
        g_prefix, g_final, prefix, chunk_decays, has_init)
    return d_states, d_decays, d_init[0] if d_init else None


ssd_state_scan_bwd.launches = 0   # kernel launches since the count was last reset


# The differentiable form, as ``flash_attention.py`` and ``moe_gating.py``
# register theirs: one op that autograd and torch.utils.checkpoint's
# selective policies see.  It saves the decays and the forward's prefix;
# its backward is ssd_state_scan_bwd.
@torch.library.custom_op("repro_torch::ssd_state_scan", mutates_args=(),
                         device_types=("cuda", "cpu"))
def _scan_op(chunk_states: torch.Tensor, chunk_decays: torch.Tensor,
             init_state: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    return ssd_state_scan_fwd(chunk_states, chunk_decays, init_state)


@_scan_op.register_fake
def _(chunk_states, chunk_decays, init_state):
    B, _, H, P, N = chunk_states.shape
    return chunk_states.new_empty(chunk_states.shape), chunk_states.new_empty((B, H, P, N))


def _setup_context(ctx, inputs, output):
    _, chunk_decays, init_state = inputs
    prefix, _ = output
    ctx.set_materialize_grads(False)       # an unread output's gradient is None
    ctx.save_for_backward(prefix, chunk_decays)
    ctx.has_init = init_state is not None


def _backward(ctx, g_prefix, g_final):
    prefix, chunk_decays = ctx.saved_tensors
    if g_prefix is None and g_final is None:
        return None, None, None
    g_prefix = torch.zeros_like(prefix) if g_prefix is None else g_prefix.contiguous()
    g_final = None if g_final is None else g_final.contiguous()
    d_states, d_decays, d_init = ssd_state_scan_bwd(
        g_prefix, g_final, prefix, chunk_decays, ctx.has_init and ctx.needs_input_grad[2])
    return (d_states if ctx.needs_input_grad[0] else None,
            d_decays if ctx.needs_input_grad[1] else None, d_init)


_scan_op.register_autograd(_backward, setup_context=_setup_context)


def ssd_state_scan(chunk_states: torch.Tensor, chunk_decays: torch.Tensor,
                   init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """chunk_states: (B,C,H,P,N); chunk_decays: (B,C,H); init_state:
    (B,H,P,N) or None (zeros) -> (prefix (B,C,H,P,N), final (B,H,P,N)), as
    ``ssd_state_scan_fwd``: one launch, through the registered op, whose
    backward (where autograd needs a gradient) is ``ssd_state_scan_bwd``."""
    return torch.ops.repro_torch.ssd_state_scan(chunk_states, chunk_decays, init_state)


ssd_state_scan.launches = 0   # forward kernel launches since the count was last reset
