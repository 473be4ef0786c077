#!/usr/bin/env python3
"""Train zamba2-2.7b as ``chip_smoke.py`` phase 11 does, at three peak
learning rates, on one GPU, and print each run's losses.

    python3 scripts/hybrid_lr_sweep.py

Each run is ``run_training`` at full width and depth: 10 steps of 4 x 1024
synthetic tokens (seed 0), warmup-cosine to the peak, remat "full", f32
AdamW moments, no checkpoints.  The runs share the data and the initial
weights, so they differ only in the peak learning rate: the evidence for
the peak phase 11 trains at (``chip_smoke.HYBRID_TRAIN_RUN``).
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

PEAKS = (3e-3, 1e-3, 3e-4)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("hybrid_lr_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs.base import get_config
    from repro_torch.train.trainer import run_training
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("zamba2-2.7b")
    for lr in PEAKS:
        t0 = time.perf_counter()
        res = run_training(cfg, steps=10, batch=4, seq=1024, lr=lr, remat="full", seed=0,
                           device="cuda")
        print(f"peak lr {lr}: losses {[round(x, 4) for x in res.losses]} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        res.state = None
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
