"""Meshes and per-arch axis rules, ported from ``repro/launch/mesh.py``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh``; building one
needs the default process group of its size, which the caller starts
(``torch.distributed.init_process_group``).  ``make_production_mesh``
waits for the port's sharded layouts.
"""

from __future__ import annotations

from typing import Optional

from ..configs.base import ArchConfig
from ..models.sharding import DEFAULT_RULES, AxisRules

__all__ = ["make_local_mesh", "rules_for"]


def make_local_mesh(device=None):
    """A 1 x 1 mesh with the production axis names, on ``device``'s type
    (the card unless told otherwise); the process group has one rank."""
    from torch.distributed.device_mesh import init_device_mesh

    from .. import resolve_device
    return init_device_mesh(resolve_device(device).type, (1, 1),
                            mesh_dim_names=("data", "model"))


# FSDP threshold: params whose bf16 copy + fp32 moments cannot be
# model-axis-sharded alone into 16 GB HBM.
_FSDP_PARAM_THRESHOLD = 20_000_000_000
# Below this, 16-way tensor parallel costs more in per-layer activation
# gathers than it saves: run pure data parallel over the WHOLE mesh
# (batch over pod x data x model), replicate weights, one grad all-reduce.
_TP_PARAM_THRESHOLD = 1_500_000_000


def rules_for(cfg: ArchConfig, *, model_axis: int = 16,
              fsdp: Optional[bool] = None,
              seq_shard_cache: bool = False,
              force_tp: Optional[bool] = None) -> AxisRules:
    """Axis rules adapted to the architecture, the reference's thresholds on
    the port's ``param_count``."""
    from ..models.model import param_count
    rules = dict(DEFAULT_RULES)
    n_params = param_count(cfg)
    if fsdp is None:
        fsdp = n_params >= _FSDP_PARAM_THRESHOLD
    if fsdp:
        rules["fsdp"] = "data"
    use_tp = n_params >= _TP_PARAM_THRESHOLD if force_tp is None else force_tp
    if not use_tp:
        rules["tp"] = None
        rules["vocab"] = None
        rules["tp_ff"] = None
        rules["batch"] = ("pod", "data", "model")   # DP over the whole mesh
    if cfg.is_moe:
        if cfg.n_experts >= model_axis:
            rules["expert"] = "model"     # expert parallel
            rules["tp_ff"] = None
        else:
            rules["expert"] = None        # few big experts: TP inside expert
            rules["tp_ff"] = "model"
    if seq_shard_cache:
        rules["seq"] = "data"
    return rules
