"""Qwen3-30B-A3B: 128-expert top-8 MoE. [hf:Qwen/Qwen3-30B-A3B; hf]"""

from dataclasses import replace

from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,               # per-expert intermediate size
    vocab=151_936,
    head_dim=128,           # Qwen3 uses explicit 128-dim heads
    qk_norm=True,
    rope_theta=1e6,
    n_experts=128,
    top_k=8,
    source="hf:Qwen/Qwen3-30B-A3B",
    notes="MoE 128e top-8, GQA kv=4, qk_norm",
)


def smoke() -> ArchConfig:
    return replace(CONFIG, arch_id="qwen3-moe-smoke", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, head_dim=16, d_ff=32, vocab=256,
                   n_experts=8, top_k=2)
