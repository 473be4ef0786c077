"""Grok-1 314B: 8-expert top-2 MoE. [hf:xai-org/grok-1; unverified]"""

from dataclasses import replace

from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32_768,            # per-expert intermediate size
    vocab=131_072,
    head_dim=128,
    rope_theta=1e4,
    n_experts=8,
    top_k=2,
    source="hf:xai-org/grok-1",
    notes="MoE 8e top-2, GQA kv=8",
)


def smoke() -> ArchConfig:
    return replace(CONFIG, arch_id="grok-1-smoke", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
                   n_experts=4, top_k=2)
