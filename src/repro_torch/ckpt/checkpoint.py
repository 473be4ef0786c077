"""Named checkpoints in the data lake, ported from
``repro/ckpt/checkpoint.py``: the same names and the same arrays, so either
framework resumes the other's run::

    /lidc/data/ckpt/<run>/step=<N>        (the flattened train state)
    /lidc/data/ckpt/<run>/latest          (json pointer {step, run, ...})

The arrays are the reference's ``_flatten`` of its train state
(``interop.state_to_jax``): ``params/...``, ``opt/.m/...``, ``opt/.v/...``,
``opt/.step``, layers stacked along leading dims, bf16 stored as f32 (a
lossless container for it).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from .. import resolve_device
from ..interop import load_named, state_to_jax
from ..lake import DATA_PREFIX, LakeName
from ..optim.adamw import AdamWState

__all__ = ["ckpt_prefix", "save_checkpoint", "restore_checkpoint", "latest_step"]

State = Dict[str, Any]


def ckpt_prefix(run: str) -> LakeName:
    return LakeName.parse(DATA_PREFIX).append("ckpt", run)


def save_checkpoint(lake, run: str, step: int, state: State,
                    meta: Optional[Dict[str, Any]] = None) -> LakeName:
    """Write the whole train state, then advance the 'latest' pointer (object
    first, pointer second: a torn write leaves the old pointer)."""
    name = ckpt_prefix(run).append(f"step={step}")
    lake.put_arrays(name, state_to_jax(state))
    lake.put_json(ckpt_prefix(run).append("latest"),
                  {"step": step, "run": run, **(meta or {})})
    return name


def latest_step(lake, run: str) -> Optional[int]:
    ptr = lake.get_json(ckpt_prefix(run).append("latest"))
    return None if ptr is None else int(ptr["step"])


def _empty_like(model: nn.Module, device: torch.device) -> nn.Module:
    """A module of ``model``'s structure with fresh, uninitialised parameters
    on ``device`` (``model``'s own data is not copied)."""
    memo = {id(p): nn.Parameter(torch.empty_like(p, device="meta"),
                                requires_grad=p.requires_grad)
            for p in model.parameters()}
    return copy.deepcopy(model, memo).to_empty(device=device)


def restore_checkpoint(lake, run: str, template: State, step: Optional[int] = None, *,
                       device=None) -> Tuple[State, int]:
    """A new train state of ``template``'s structure (a meta one from
    ``train.step.train_state_shape`` will do) holding checkpoint ``step``
    (default: latest), on ``device`` (default: the template's, or the card
    for a meta template)."""
    if step is None:
        step = latest_step(lake, run)
        if step is None:
            raise FileNotFoundError(f"no checkpoint for run {run!r}")
    arrays = lake.get_arrays(ckpt_prefix(run).append(f"step={step}"))
    if arrays is None:
        raise FileNotFoundError(f"checkpoint step {step} missing for {run!r}")
    tparams, topt = template["params"], template["opt"]
    if device is None and topt.step.device.type != "meta":
        device = topt.step.device
    device = resolve_device(device)
    params = _empty_like(tparams, device)
    load_named(arrays, params.named_parameters(), "params/")
    m, v = ({n: torch.empty(t.shape, dtype=t.dtype, device=device) for n, t in moments.items()}
            for moments in (topt.m, topt.v))
    load_named(arrays, m.items(), "opt/.m/")
    load_named(arrays, v.items(), "opt/.v/")
    opt_step = torch.tensor(int(arrays["opt/.step"]), dtype=torch.int32, device=device)
    return {"params": params, "opt": AdamWState(opt_step, m, v)}, step
