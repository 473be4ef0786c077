"""PyTorch / CUDA port of the LIDC reproduction's tensor code.

The JAX package ``repro`` is the reference; this package computes the same
functions with PyTorch on an NVIDIA H100 and imports nothing of ``repro``
or of JAX.  Attention runs through hand-written CUDA kernels
(``kernels/csrc``) on the card and through their plain PyTorch versions
on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  With no card and no explicit device this raises; nothing
    silently continues on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
