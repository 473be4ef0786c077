"""Logical-axis sharding rules, ported from ``repro/models/sharding.py``
(the rules part; ``param_pspecs`` and ``shard`` wait for the port's
sharded layouts).

Weights and activations are named by *logical* axes, which the rules in
force map onto the axes of the mesh in force.  The baseline recipe:

* ``batch``   -> ("pod", "data")     (DP over pods and the data axis)
* ``tp``      -> "model"             (Megatron tensor parallel)
* ``expert``  -> "model"             (expert parallel, MoE with E >= axis)
* ``fsdp``    -> "data"              (parameter/optimizer sharding, big archs)
* ``seq``     -> "data"              (sequence-sharded long-context caches)

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose
``mesh_dim_names`` are the axis names, put in force with ``use_mesh``; a
collective over a mesh axis is a collective over that dim's process group
(``repro_torch.collectives``).  A pspec is a tuple with one entry per
tensor dim: ``None``, an axis name, or a tuple of axis names.  A rule maps
to ``None`` when its mesh axes are absent or do not divide the dim.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict, Optional, Sequence, Tuple, Union

__all__ = ["AxisRules", "DEFAULT_RULES", "FSDP_RULES", "set_rules", "current_rules",
           "use_rules", "use_mesh", "current_mesh", "logical_to_pspec", "gqa_axes",
           "axis_size"]

Logical = Optional[Union[str, Tuple[str, ...]]]

# logical axis name -> mesh axis (or tuple of mesh axes) or None
AxisRules = Dict[str, Any]

DEFAULT_RULES: AxisRules = {
    "batch": ("pod", "data"),
    "tp": "model",
    "expert": "model",
    "tp_ff": None,         # MoE inner-dim TP (used when E < model axis)
    "fsdp": None,          # off in the faithful baseline for small archs
    "seq": "data",
    "vocab": "model",
}

FSDP_RULES: AxisRules = dict(DEFAULT_RULES, fsdp="data")

_ACTIVE: AxisRules = {}
_MESH = None   # the DeviceMesh in force (use_mesh), or None


def set_rules(rules: AxisRules) -> None:
    global _ACTIVE
    _ACTIVE = dict(rules)


def current_rules() -> AxisRules:
    return _ACTIVE


@contextmanager
def use_rules(rules: AxisRules):
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = dict(rules)
    try:
        yield
    finally:
        _ACTIVE = prev


@contextmanager
def use_mesh(mesh):
    """Put ``mesh`` (a ``DeviceMesh`` with ``mesh_dim_names``) in force, as
    the reference's ``with mesh:`` does."""
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def current_mesh():
    return _MESH


def _mesh_axes() -> Dict[str, int]:
    """Axis sizes of the mesh in force (empty if none)."""
    if _MESH is None:
        return {}
    return dict(zip(_MESH.mesh_dim_names, _MESH.shape))


def _resolve(logical: Logical, mesh_axes: Dict[str, int], dim: Optional[int]) -> Any:
    """Map one logical axis to mesh axes, dropping unmapped/ill-fitting ones.

    When the full axis product does not divide the dimension, fall back to
    the longest contiguous run of axes that does (batch=128 can't take
    pod*data*model=512 but happily takes pod*data=32).
    """
    if logical is None:
        return None
    rule = _ACTIVE.get(logical, None) if isinstance(logical, str) else logical
    if rule is None:
        return None
    axes = (rule,) if isinstance(rule, str) else tuple(rule)
    live = [a for a in axes if a in mesh_axes]
    if not live:
        return None
    if dim is not None:
        best: list = []
        best_total = 1
        n = len(live)
        for i in range(n):
            for j in range(i + 1, n + 1):
                cand = live[i:j]
                total = 1
                for a in cand:
                    total *= mesh_axes[a]
                if total > 0 and dim % total == 0 and total > best_total:
                    best, best_total = cand, total
        live = best
        if not live:
            return None
    if len(live) == 1:
        return live[0]
    return tuple(live)


def logical_to_pspec(logical_axes: Sequence[Logical],
                     shape: Optional[Sequence[int]] = None) -> Tuple[Any, ...]:
    mesh_axes = _mesh_axes()
    dims = list(shape) if shape is not None else [None] * len(logical_axes)
    return tuple(_resolve(l, mesh_axes, d) for l, d in zip(logical_axes, dims))


def gqa_axes(n_kv: int, head_dim: int):
    """Where to put 'tp' for GQA tensors laid out (..., K, [G,] hd).

    Returns (kv_axis, hd_axis) logical names: shard the kv-head dim when it
    divides the model axis (attention fully local per head group), else
    shard head_dim on BOTH q and cache so the contraction is a local
    partial sum + small psum — never an all-gather of the cache.
    """
    tp = _ACTIVE.get("tp")
    sizes = _mesh_axes()
    n = sizes.get(tp, 1) if isinstance(tp, str) else 1
    if n <= 1:
        return None, None
    if n_kv % n == 0:
        return "tp", None
    if head_dim % n == 0:
        return None, "tp"
    return None, None


def axis_size(*mesh_axis_names: str) -> int:
    sizes = _mesh_axes()
    out = 1
    for a in mesh_axis_names:
        out *= sizes.get(a, 1)
    return out
