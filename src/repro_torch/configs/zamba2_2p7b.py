"""Zamba2-2.7B: Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]"""

from dataclasses import replace

from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="zamba2-2.7b",
    family="hybrid",
    n_layers=54,            # Mamba2 blocks
    d_model=2560,
    n_heads=32,             # attention heads of the shared block
    n_kv_heads=32,
    d_ff=10_240,            # shared block MLP
    vocab=32_000,
    rope_theta=1e4,
    ssm_state=64,
    ssm_heads=64,           # value heads: d_inner(=2*d_model) / headdim(80)
    ssm_expand=2,
    conv_kernel=4,
    chunk=256,
    attn_every=6,           # shared attention applied every 6 mamba blocks
    source="arXiv:2411.15242",
    notes="Mamba2 + shared attn blocks (concat-with-embedding input)",
)


def smoke() -> ArchConfig:
    return replace(CONFIG, arch_id="zamba2-smoke", n_layers=4, d_model=64,
                   n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
                   ssm_state=16, ssm_heads=4, chunk=16, attn_every=2)
