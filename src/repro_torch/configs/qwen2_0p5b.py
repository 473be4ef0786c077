"""Qwen2-0.5B: dense, GQA, QKV bias. [arXiv:2407.10671; hf]"""

from dataclasses import replace

from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151_936,
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
    source="arXiv:2407.10671",
    notes="GQA, QKV bias",
)


def smoke() -> ArchConfig:
    return replace(CONFIG, arch_id="qwen2-smoke", n_layers=2, d_model=56,
                   n_heads=7, n_kv_heads=1, d_ff=128, vocab=256)
