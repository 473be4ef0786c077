"""xLSTM-350M: sLSTM + mLSTM blocks. [arXiv:2405.04517; unverified]"""

from dataclasses import replace

from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                 # no separate FFN: projections live in the blocks
    vocab=50_304,
    slstm_every=8,          # xLSTM[7:1]: one sLSTM block per 8
    conv_kernel=4,
    chunk=64,               # mLSTM chunkwise-parallel chunk length
    source="arXiv:2405.04517",
    notes="sLSTM + mLSTM blocks, 7:1 ratio",
)


def smoke() -> ArchConfig:
    return replace(CONFIG, arch_id="xlstm-smoke", n_layers=4, d_model=64,
                   n_heads=2, n_kv_heads=2, vocab=256, slstm_every=2, chunk=8)
