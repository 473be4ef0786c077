"""Chameleon-34B: early-fusion VLM backbone. [arXiv:2405.09818; unverified]

The VQ image tokenizer is a STUB per the assignment: inputs are already
token ids in the fused 65536 vocabulary (text + image codes); only the
transformer backbone is modeled.  Chameleon's qk-norm (its divergence fix)
is on.
"""

from dataclasses import replace

from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22_016,
    vocab=65_536,
    qk_norm=True,
    rope_theta=1e4,
    source="arXiv:2405.09818",
    notes="early-fusion, VQ image tokens (tokenizer stubbed)",
)


def smoke() -> ArchConfig:
    return replace(CONFIG, arch_id="chameleon-smoke", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, d_ff=128, vocab=512)
