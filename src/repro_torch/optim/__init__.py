"""AdamW and learning-rate schedules, ported from ``repro/optim``."""

from .adamw import AdamW, AdamWState
from .schedule import constant, warmup_cosine

__all__ = ["AdamW", "AdamWState", "warmup_cosine", "constant"]
