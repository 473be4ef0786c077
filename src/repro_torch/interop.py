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

The whole train state crosses too (``state_from_jax`` / ``state_to_jax``),
under the keys the reference's checkpoint gives it: ``params/<key>``, the
AdamW moments ``opt/.m/<key>`` and ``opt/.v/<key>`` (f32, stacked as the
parameters are), and the step ``opt/.step`` (a 0-dim int32).  A run can
resume in either framework from the other's checkpoint.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch
from torch import nn

from . import resolve_device
from .configs.base import ArchConfig
from .models.model import model_module
from .models.transformer import dtype_of
from .optim.adamw import AdamWState

__all__ = ["params_from_jax", "params_to_jax", "state_from_jax", "state_to_jax",
           "load_named", "named_to_jax"]

Named = Iterable[Tuple[str, torch.Tensor]]


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


def _stacked(named: Named) -> Dict[str, Dict[Tuple[int, ...], torch.Tensor]]:
    """JAX key -> {index in the stacked dims: the port's tensor}, from
    (port name, tensor) pairs."""
    out: Dict[str, Dict[Tuple[int, ...], torch.Tensor]] = {}
    for name, p in named:
        key, idx = _jax_key(name)
        out.setdefault(key, {})[idx] = p
    return out


def _lead(idxs) -> Tuple[int, ...]:
    return tuple(int(i) + 1 for i in np.max(list(idxs), axis=0)) if any(idxs) else ()


@torch.no_grad()
def load_named(arrays: Dict[str, np.ndarray], named: Named, prefix: str = "") -> None:
    """Copy ``arrays[prefix + key]`` into the tensors of ``named`` in place,
    each its slice of the stacked leading dims, cast to its dtype.  Raises
    on a key missing from either side or a shape that differs."""
    tensors = _stacked(named)
    keys = {k[len(prefix):] for k in arrays if k.startswith(prefix)}
    if keys - set(tensors):
        raise KeyError(f"no tensor of the keys {sorted(keys - set(tensors))} in the port")
    if set(tensors) - keys:
        raise KeyError(f"missing from the JAX arrays: {sorted(set(tensors) - keys)}")
    for key, parts in tensors.items():
        arr = np.asarray(arrays[prefix + key], dtype=np.float32)
        lead = _lead(parts)
        if arr.shape[:len(lead)] != lead:
            raise ValueError(f"{key}: leading dims {arr.shape[:len(lead)]} != {lead}")
        for idx, p in parts.items():
            if tuple(p.shape) != arr[idx].shape:
                raise ValueError(f"{key}{list(idx)}: shape {arr[idx].shape} != "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.tensor(arr[idx]))


def named_to_jax(named: Named) -> Dict[str, np.ndarray]:
    """Flattened f32 numpy arrays with the JAX keys, the tensors of module
    lists stacked along leading dims, one per index."""
    out: Dict[str, np.ndarray] = {}
    for key, parts in _stacked(named).items():
        lead = _lead(parts)
        values = [parts[idx].detach().float().cpu().numpy() for idx in np.ndindex(lead)]
        out[key] = np.stack(values).reshape(lead + values[0].shape)
    return out


def params_from_jax(arrays: Dict[str, np.ndarray], cfg: ArchConfig, *,
                    device=None) -> nn.Module:
    """Build the port's model of ``cfg``'s family from flattened JAX
    parameters, splitting each stacked array into its modules."""
    device = resolve_device(device)
    model = model_module(cfg).Model(cfg, device=device, dtype=dtype_of(cfg))
    load_named(arrays, model.named_parameters())
    return model


def params_to_jax(model: nn.Module) -> Dict[str, np.ndarray]:
    """The inverse of ``params_from_jax``."""
    return named_to_jax(model.named_parameters())


def state_from_jax(arrays: Dict[str, np.ndarray], cfg: ArchConfig, *,
                   device=None) -> dict:
    """The port's train state ({"params", "opt"}, as ``train.step.
    make_train_state`` builds it, parameters requiring grad) from the
    reference's flattened train state."""
    device = resolve_device(device)
    params = params_from_jax({k[len("params/"):]: a for k, a in arrays.items()
                              if k.startswith("params/")}, cfg, device=device)
    params.requires_grad_(True)
    m, v = ({n: torch.empty(p.shape, dtype=torch.float32, device=device)
             for n, p in params.named_parameters()} for _ in range(2))
    load_named(arrays, m.items(), "opt/.m/")
    load_named(arrays, v.items(), "opt/.v/")
    step = torch.tensor(int(arrays["opt/.step"]), dtype=torch.int32, device=device)
    return {"params": params, "opt": AdamWState(step, m, v)}


def state_to_jax(state: dict) -> Dict[str, np.ndarray]:
    """The reference's flattened train state from the port's: every key of
    its checkpoint, bf16 as f32, the step a 0-dim int32."""
    opt = state["opt"]
    out = {f"params/{k}": a for k, a in params_to_jax(state["params"]).items()}
    out.update({f"opt/.m/{k}": a for k, a in named_to_jax(opt.m.items()).items()})
    out.update({f"opt/.v/{k}": a for k, a in named_to_jax(opt.v.items()).items()})
    out["opt/.step"] = np.asarray(int(opt.step), dtype=np.int32)
    return out
