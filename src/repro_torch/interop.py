"""Weights across frameworks: the JAX package's flattened parameter arrays
to the port's model and back.

The keys are those of ``repro/ckpt/checkpoint.py::_flatten``: '/'-joined
tree paths such as ``embed/table`` or ``blocks/attn/wq``, where every
``blocks/...`` array carries a leading layer dim.  Values are numpy arrays;
bf16 travels as f32 (numpy has no bf16 that ``torch.from_numpy`` reads), and
is cast to the config's dtype on the way in.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import resolve_device
from .configs.base import ArchConfig
from .models.transformer import Transformer, dtype_of

__all__ = ["params_from_jax", "params_to_jax"]

_BLOCKS = "blocks/"


def params_from_jax(arrays: Dict[str, np.ndarray], cfg: ArchConfig, *,
                    device=None) -> Transformer:
    """Build the port's model from flattened JAX parameters, splitting each
    stacked ``blocks/...`` array into the per-layer modules."""
    device = resolve_device(device)
    model = Transformer(cfg, device=device, dtype=dtype_of(cfg))
    params = dict(model.named_parameters())
    seen = set()
    for key, arr in arrays.items():
        arr = np.asarray(arr, dtype=np.float32)
        if key.startswith(_BLOCKS):
            if arr.shape[0] != cfg.n_layers:
                raise ValueError(f"{key}: leading dim {arr.shape[0]} != "
                                 f"n_layers {cfg.n_layers}")
            targets = [(f"blocks.{i}.{key[len(_BLOCKS):].replace('/', '.')}", arr[i])
                       for i in range(cfg.n_layers)]
        else:
            targets = [(key.replace("/", "."), arr)]
        for name, value in targets:
            if name not in params:
                raise KeyError(f"{key}: no parameter {name} in the port's model")
            if tuple(params[name].shape) != value.shape:
                raise ValueError(f"{name}: shape {value.shape} != "
                                 f"{tuple(params[name].shape)}")
            with torch.no_grad():
                params[name].copy_(torch.tensor(value))
            seen.add(name)
    missing = sorted(set(params) - seen)
    if missing:
        raise KeyError(f"parameters missing from the JAX arrays: {missing}")
    return model


def params_to_jax(model: Transformer) -> Dict[str, np.ndarray]:
    """The inverse: flattened f32 numpy arrays with the JAX keys, the
    per-layer parameters stacked along a leading layer dim."""
    out: Dict[str, np.ndarray] = {}
    stacked: Dict[str, list] = {}
    for name, p in model.named_parameters():
        value = p.detach().float().cpu().numpy()
        if name.startswith("blocks."):
            _, _, rest = name.split(".", 2)
            stacked.setdefault(_BLOCKS + rest.replace(".", "/"), []).append(value)
        else:
            out[name.replace(".", "/")] = value
    for key, values in stacked.items():
        out[key] = np.stack(values)
    return out
