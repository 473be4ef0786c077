"""Hand-written CUDA kernels for the attention, MoE-router and SSD-scan hot
spots, with their plain PyTorch versions (``ref``) and the device dispatch
the models call (``ops``), and the fused AdamW update (``adamw``, whose
plain version is ``optim/adamw.py``'s loop).  Importing this package builds
nothing; the first launch builds the library.
"""

from . import ops, ref

__all__ = ["ops", "ref"]
