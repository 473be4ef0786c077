"""Architecture + shape configuration system (the port's own copy).

The modules of this package are data: the same ``ArchConfig`` records as
the JAX package's ``configs``, copied so that ``repro_torch`` imports
nothing of ``repro``.  ``ArchConfig.param_count`` counts the port's own
model.

Every assigned architecture has one module in this package exporting
``CONFIG`` (the exact published configuration) and ``smoke()`` (a reduced
same-family configuration for CPU tests).  ``registry()`` collects them all;
``launch/*.py`` select with ``--arch <id>``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "registry", "get_config",
           "get_shape", "smoke_of"]


@dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                 # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None      # default d_model // n_heads
    # -- attention details
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    # -- MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # -- SSM / hybrid
    ssm_state: int = 0                  # Mamba2 N (state dim per head)
    ssm_heads: int = 0                  # Mamba2 value heads
    ssm_expand: int = 2
    conv_kernel: int = 4
    chunk: int = 256                    # SSD chunk length
    attn_every: int = 0                 # hybrid: shared attn every k blocks
    slstm_every: int = 0                # xlstm: sLSTM every k blocks
    # -- enc-dec
    enc_layers: int = 0
    dec_layers: int = 0
    # -- numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    # -- bookkeeping
    notes: str = ""
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve 500k-token contexts (per assignment rules)?"""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # no encoder-only arch in the assigned pool

    def param_count(self) -> int:
        """Analytic parameter count (drives 6ND and memory admission)."""
        from ..models.model import param_count
        return param_count(self)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        # tokens processed per step: decode steps emit 1 token per sequence
        if self.kind == "decode":
            return self.global_batch
        return self.seq_len * self.global_batch


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_ARCH_IDS = (
    "qwen3-moe-30b-a3b",
    "grok-1-314b",
    "zamba2-2.7b",
    "xlstm-350m",
    "qwen3-1.7b",
    "phi4-mini-3.8b",
    "qwen2-0.5b",
    "mistral-large-123b",
    "seamless-m4t-large-v2",
    "chameleon-34b",
    "lidc-demo",          # the paper's own workflow payload (tiny LM)
)


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "p")


def registry() -> Dict[str, ArchConfig]:
    import importlib
    out = {}
    for arch_id in _ARCH_IDS:
        mod = importlib.import_module(f"repro_torch.configs.{_module_name(arch_id)}")
        out[arch_id] = mod.CONFIG
    return out


def get_config(arch_id: str) -> ArchConfig:
    import importlib
    mod = importlib.import_module(f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.CONFIG


def smoke_of(arch_id: str) -> ArchConfig:
    import importlib
    mod = importlib.import_module(f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.smoke()


def shape_cells(arch: ArchConfig) -> Tuple[str, ...]:
    """The dry-run cells this arch participates in (assignment rules)."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if arch.sub_quadratic:
        cells.append("long_500k")
    return tuple(cells)
