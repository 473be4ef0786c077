"""The paper's own workflow payload: a small LM standing in for the
genomics application the paper deploys (Magic-BLAST).  Used by examples,
benchmarks and the end-to-end LIDC workflow tests — small enough to *run*
(not just compile) on CPU."""

from dataclasses import replace

from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="lidc-demo",
    family="dense",
    n_layers=4,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    d_ff=1024,
    vocab=8192,
    rope_theta=1e4,
    tie_embeddings=True,
    source="this repo",
    notes="~5M-param payload for LIDC workflow demos",
)


def smoke() -> ArchConfig:
    return replace(CONFIG, arch_id="lidc-demo-smoke", n_layers=2, d_model=64,
                   n_heads=2, n_kv_heads=1, d_ff=128, vocab=256)
