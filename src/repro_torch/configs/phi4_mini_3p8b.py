"""Phi-4-mini 3.8B: dense, RoPE SwiGLU GQA. [arXiv:2412.08905; hf]"""

from dataclasses import replace

from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=200_064,
    rope_theta=1e4,
    tie_embeddings=True,
    source="arXiv:2412.08905",
    notes="RoPE SwiGLU GQA",
)


def smoke() -> ArchConfig:
    return replace(CONFIG, arch_id="phi4-smoke", n_layers=2, d_model=96,
                   n_heads=6, n_kv_heads=2, d_ff=192, vocab=256)
