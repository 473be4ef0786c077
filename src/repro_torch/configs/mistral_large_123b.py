"""Mistral-Large 123B: dense GQA.
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]"""

from dataclasses import replace

from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12_288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28_672,
    vocab=32_768,
    rope_theta=1e6,
    source="hf:mistralai/Mistral-Large-Instruct-2407",
)


def smoke() -> ArchConfig:
    return replace(CONFIG, arch_id="mistral-smoke", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, d_ff=128, vocab=256)
