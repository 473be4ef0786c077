"""Named checkpoints in the data lake, ported from ``repro/ckpt``."""

from .checkpoint import ckpt_prefix, latest_step, restore_checkpoint, save_checkpoint

__all__ = ["ckpt_prefix", "save_checkpoint", "restore_checkpoint", "latest_step"]
