"""Wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

It replaces ``repro/kernels/flash_attention.py::flash_attention`` (Pallas
TPU) and takes what the serving and training paths send it: any Sq and Sk
(ragged tails are masked in the kernel), bf16 or f32, head dim 64, 80 or
128.  Its gradient is the hand-written backward kernel
(``csrc/flash_attention_bwd.cu``), from the log-sum-exp the forward saves.
It runs only on CUDA tensors; ``ops.attention`` sends CPU tensors to the
plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ._build import library

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "check_kernel_input", "refuse_grad"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 80, 128)


def check_kernel_input(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    """Raise unless ``t`` lies on ``like``'s CUDA device with its dtype and
    can be read with 16-byte loads: contiguous last dim, 16-byte aligned
    base and strides."""
    if not t.is_cuda or t.device != like.device:
        raise ValueError(f"{name} must be a CUDA tensor on {like.device}, got {t.device}")
    if t.dtype != like.dtype or t.dtype not in _DTYPES:
        raise ValueError(f"{name} has dtype {t.dtype}; the kernel takes f32 or bf16, "
                         f"all inputs alike ({like.dtype})")
    esz = t.element_size()
    if (t.stride(-1) != 1 or t.data_ptr() % 16
            or any(s * esz % 16 for s in t.stride()[:-1])):
        raise ValueError(f"{name} with strides {t.stride()} is not 16-byte aligned "
                         "with a contiguous last dim")


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % K:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if Sq < 1 or Sk < 1 or (causal and Sq > Sk):
        raise ValueError(f"need 1 <= Sq ({Sq}) and 1 <= Sk ({Sk}), Sq <= Sk if causal")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_kernel_input(name, t, q)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, with_lse: bool = False
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One launch of the forward kernel, no autograd: (o (B,Sq,H,hd) in q's
    dtype, and with ``with_lse`` the log-sum-exp of each query row's scaled
    scores, (B,H,Sq) f32, else None)."""
    _check_shapes(q, k, v, causal)
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    o = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if with_lse
           else None)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *o.stride()[:3])
    err = library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), _DTYPES[q.dtype],
        q.device.index, B, Sq, Sk, H, K, hd, int(causal), strides, hd ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return o, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, *, causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of the forward kernel's output ``o`` against
    ``do``, from the inputs and the forward's ``lse`` (``csrc/
    flash_attention_bwd.cu``: three launches, D = rowsum(dO * O), then dK/dV
    per key tile and dQ per query tile; in bf16 the last two are the wgmma
    kernels of ``csrc/flash_attention_bwd_sm90.cu``), in the inputs' dtype."""
    _check_shapes(q, k, v, causal)
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    for name, t in (("o", o), ("do", do)):
        check_kernel_input(name, t, q)
        if t.shape != q.shape:
            raise ValueError(f"{name} of shape {tuple(t.shape)}, expected {tuple(q.shape)}")
    if (lse.dtype != torch.float32 or lse.shape != (B, H, Sq) or not lse.is_contiguous()
            or lse.device != q.device):
        raise ValueError(f"lse must be a contiguous (B, H, Sq) = {(B, H, Sq)} f32 tensor "
                         f"on {q.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dot = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*(s for t in (q, k, v, o, do, dq, dk, dv)
                                         for s in t.stride()[:3]))
    err = library().flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dot.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _DTYPES[q.dtype], q.device.index, B, Sq, Sk, H, K, hd, int(causal), strides,
        hd ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA error {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0   # calls (three kernels each) since the count was reset


# The differentiable form: a registered operator, so that autograd and
# torch.utils.checkpoint's selective policies see one op (a ctypes launch is
# invisible to them).  Its forward writes the log-sum-exp and saves it with
# q, k, v and o; its backward is flash_attention_bwd.
@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(), device_types="cuda")
def _attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    return flash_attention_fwd(q, k, v, causal=causal, with_lse=True)


@_attention_op.register_fake
def _(q, k, v, causal):
    B, Sq, H, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((B, H, Sq), dtype=torch.float32)


def _setup_context(ctx, inputs, output):
    q, k, v, causal = inputs
    o, lse = output
    ctx.mark_non_differentiable(lse)
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.causal = causal


def _backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(), causal=ctx.causal)
    return dq, dk, dv, None


_attention_op.register_autograd(_backward, setup_context=_setup_context)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B,Sq,H,hd); k/v: (B,Sk,K,hd), H % K == 0 -> (B,Sq,H,hd) in q's
    dtype.  Causal queries are the last Sq of the Sk positions.  Where
    autograd needs a gradient (grad mode on, an input requiring grad) the
    call goes through the registered operator, whose backward is the
    backward kernel; otherwise (serving) one forward launch, no
    log-sum-exp."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return torch.ops.repro_torch.flash_attention(q, k, v, causal)[0]
    return flash_attention_fwd(q, k, v, causal=causal)[0]


flash_attention.launches = 0   # forward kernel launches since the count was last reset


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would need a gradient through kernel ``name``,
    which has no backward yet: its output would carry none, and training
    would silently stop upstream of it."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward yet; see ROADMAP (Queue 2). Call it "
                           "under torch.no_grad(), or on inputs that do not require grad")
