"""The model families the benchmark runs, one module each.

A configuration file names its family (``"family": "dense"``), and
``of(cfg)`` resolves it to ``families/<family>.py``.  Everything of the
benchmark that depends on a model's shape goes through that module: the
harness, the drivers, the plain reference, the metric readers and the
faults take it as an argument, and a result's record carries its name
(``record["family"]``) beside its ``spec``.  So a model of another family
is added as new files alone: its family module, configuration, traffic
mix, limits and entries.

A family module provides:

- ``spec_of(cfg)``: the configuration's shapes, an object with at least
  ``vocab``, ``dtype`` (the served dtype's name) and ``dtype_bytes``, and
  ``heads``, ``kv_heads`` and ``head_dim`` of its attention layers;
- ``arch_config(cfg, spec, name)``: the port's ``ArchConfig``, every size
  taken from the file;
- ``groups(spec)``: the groups of leaves drawn together, ``weights.TOP``
  (the leaves outside the blocks) first, then one a block; and
  ``leaves(spec, group)``: a group's leaves as ``(full name, shape, init)``,
  named as the port's model names them, ``init`` one of ``weights``'
  scalings or a function of the same form;
- the plain float32 reference: ``embed(spec, W, tokens)``,
  ``block(spec, W, group, h, quant)`` (the block of ``group`` on hidden
  states h) and ``final_logits(spec, W, h, quant)``, built from
  ``reference``'s operations and importing nothing of the program;
- the counts: ``prefill_counts(spec, seq)``,
  ``decode_step_counts(spec, active, active_positions, rows, all_positions)``
  and ``train_flops(spec, batch, seq)``, and ``attention_layers(spec)``,
  the number of layers that run attention;
- the faults: ``planted(fault)``, a context that plants the family's part
  of a serving fault (its cache write and its decode step), and
  ``MOVED_TWICE``, the leaf whose update the training fault
  ``answer_altered`` applies twice;
- ``small(cfg)``: the configuration at the size of the CPU tests.
"""

from __future__ import annotations

import importlib
from pathlib import Path
from types import ModuleType
from typing import Dict, List

__all__ = ["present", "named", "of"]

HERE = Path(__file__).resolve().parent


def present() -> List[str]:
    """The names of the family modules in this folder."""
    return sorted(p.stem for p in HERE.glob("*.py") if p.stem != "__init__")


def named(name: str) -> ModuleType:
    """The module of the family ``name``."""
    if name not in present():
        raise ValueError(f"no family {name!r}: the families present are {present()}")
    return importlib.import_module(f"{__name__}.{name}")


def of(cfg: Dict) -> ModuleType:
    """The module of the family that a configuration file names."""
    if "family" not in cfg:
        raise ValueError(f"the configuration names no \"family\": the families present are "
                         f"{present()}")
    return named(cfg["family"])
