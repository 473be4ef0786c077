"""SeamlessM4T-large v2: enc-dec multimodal backbone.
[arXiv:2308.11596; hf]

The speech/audio frontend is a STUB per the assignment: ``input_specs``
provides precomputed frame embeddings (batch, frames, d_model); only the
transformer backbone is modeled (24 encoder + 24 decoder layers).
"""

from dataclasses import replace

from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="seamless-m4t-large-v2",
    family="encdec",
    n_layers=48,            # 24 enc + 24 dec
    enc_layers=24,
    dec_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256_206,
    rope_theta=1e4,
    source="arXiv:2308.11596",
    notes="enc-dec, multimodal; frontend stubbed to frame embeddings",
)


def smoke() -> ArchConfig:
    return replace(CONFIG, arch_id="seamless-smoke", n_layers=4, enc_layers=2,
                   dec_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                   d_ff=128, vocab=256)
