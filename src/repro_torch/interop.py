"""Weights across frameworks: the JAX package's flattened parameter arrays
to the port's model and back.

The keys are those of ``repro/ckpt/checkpoint.py::_flatten``: '/'-joined
tree paths such as ``embed/table`` or ``blocks/attn/wq``.  Where the JAX
package stacks layers along leading dims, the port keeps one module per
index, and the module-list indices in its parameter names say which dims
are stacked: ``blocks.3.moe.w_gate`` is ``blocks/moe/w_gate[3]`` (one
layer dim, ``(L, E, D, F)``), the hybrid's ``mamba.2.5.ssm.in_proj`` is
``mamba/ssm/in_proj[2, 5]`` (``(n_super, attn_every, ...)``),
``proj_in.2.w`` is ``proj_in/w[2]``, and ``shared.attn.wq`` is
``shared/attn/wq`` (none).  Values are numpy arrays; bf16 travels as f32
(numpy has no bf16 that ``torch.from_numpy`` reads), and is cast to each
parameter's dtype on the way in.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from . import resolve_device
from .configs.base import ArchConfig
from .models.model import model_module
from .models.transformer import dtype_of

__all__ = ["params_from_jax", "params_to_jax"]


def _jax_key(name: str) -> Tuple[str, Tuple[int, ...]]:
    """A port parameter name -> (its JAX key, its index in the stacked
    leading dims): the numeric parts after the first are module-list
    indices, e.g. ``mamba.2.5.ssm.in_proj`` -> (``mamba/ssm/in_proj``,
    (2, 5)); ``shared.attn.wq`` -> (``shared/attn/wq``, ())."""
    head, *parts = name.split(".")
    n = 0
    while parts[n].isdigit():
        n += 1
    return "/".join([head, *parts[n:]]), tuple(int(i) for i in parts[:n])


def _stacked(model: nn.Module) -> Dict[str, Dict[Tuple[int, ...], torch.Tensor]]:
    """JAX key -> {index in the stacked dims: the port's parameter}."""
    out: Dict[str, Dict[Tuple[int, ...], torch.Tensor]] = {}
    for name, p in model.named_parameters():
        key, idx = _jax_key(name)
        out.setdefault(key, {})[idx] = p
    return out


def _lead(idxs) -> Tuple[int, ...]:
    return tuple(int(i) + 1 for i in np.max(list(idxs), axis=0)) if any(idxs) else ()


def params_from_jax(arrays: Dict[str, np.ndarray], cfg: ArchConfig, *,
                    device=None) -> nn.Module:
    """Build the port's model of ``cfg``'s family from flattened JAX
    parameters, splitting each stacked array into its modules."""
    device = resolve_device(device)
    model = model_module(cfg).Model(cfg, device=device, dtype=dtype_of(cfg))
    params = _stacked(model)
    for key, arr in arrays.items():
        if key not in params:
            raise KeyError(f"{key}: no parameter of that key in the port's model")
        arr = np.asarray(arr, dtype=np.float32)
        lead = _lead(params[key])
        if arr.shape[:len(lead)] != lead:
            raise ValueError(f"{key}: leading dims {arr.shape[:len(lead)]} != {lead}")
        for idx, p in params[key].items():
            if tuple(p.shape) != arr[idx].shape:
                raise ValueError(f"{key}{list(idx)}: shape {arr[idx].shape} != "
                                 f"{tuple(p.shape)}")
            with torch.no_grad():
                p.copy_(torch.tensor(arr[idx]))
    missing = sorted(set(params) - set(arrays))
    if missing:
        raise KeyError(f"parameters missing from the JAX arrays: {missing}")
    return model


def params_to_jax(model: nn.Module) -> Dict[str, np.ndarray]:
    """The inverse: flattened f32 numpy arrays with the JAX keys, the
    parameters of module lists stacked along leading dims, one per index."""
    out: Dict[str, np.ndarray] = {}
    for key, params in _stacked(model).items():
        lead = _lead(params)
        values = [params[idx].detach().float().cpu().numpy() for idx in np.ndindex(lead)]
        out[key] = np.stack(values).reshape(lead + values[0].shape)
    return out
