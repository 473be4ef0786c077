"""Qwen3-1.7B: dense, qk_norm, GQA. [hf:Qwen/Qwen3-8B family; hf]"""

from dataclasses import replace

from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=6144,
    vocab=151_936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-8B",
    notes="qk_norm, GQA",
)


def smoke() -> ArchConfig:
    return replace(CONFIG, arch_id="qwen3-smoke", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=256)
