"""Token data pipelines, ported from ``repro/data``."""

from .pipeline import LakeCorpus, Prefetcher, SyntheticLM, make_pipeline

__all__ = ["SyntheticLM", "LakeCorpus", "Prefetcher", "make_pipeline"]
