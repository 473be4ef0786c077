"""Wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

It replaces ``repro/kernels/flash_attention.py::flash_attention`` (Pallas
TPU) and takes what the serving path sends it: any Sq and Sk (ragged tails
are masked in the kernel), bf16 or f32, head dim 64, 80 or 128.  It runs
only on CUDA tensors; ``ops.attention`` sends CPU tensors to the plain
version.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import library

__all__ = ["flash_attention", "check_kernel_input"]

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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B,Sq,H,hd); k/v: (B,Sk,K,hd), H % K == 0 -> (B,Sq,H,hd) in q's
    dtype.  Causal queries are the last Sq of the Sk positions."""
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
    o = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *o.stride()[:3])
    err = library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _DTYPES[q.dtype],
        q.device.index, B, Sq, Sk, H, K, hd, int(causal), strides, hd ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0   # kernel launches since the count was last reset
