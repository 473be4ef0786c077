"""End-to-end driver, ported from ``examples/train_100m.py``: train a
~100M-parameter LM (lidc-100m, f32) for a few hundred steps.

Synthetic learnable stream, named checkpoints into a directory-backed data
lake every 25 steps, warmup-cosine schedule, the loss of every step
printed.  Interrupt it and rerun: it resumes from the latest named
checkpoint (the LIDC property).  The flags, defaults, lake layout and run
name are the reference example's, so a run started by either framework
resumes on the other.

    PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 200
    PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 20 --device cpu

Runs on the card unless ``--device cpu`` is given.  ``--ckpt-every``
(default the reference's 25) lets a short run checkpoint more often.
"""

from __future__ import annotations

import argparse
import sys

from ..configs.base import ArchConfig

CONFIG_100M = ArchConfig(
    arch_id="lidc-100m",
    family="dense",
    n_layers=10,
    d_model=640,
    n_heads=10,
    n_kv_heads=5,
    d_ff=2560,
    vocab=50_304,
    rope_theta=1e4,
    tie_embeddings=True,
    dtype="float32",
    source="this repo (examples/train_100m.py)",
)
RUN_NAME = "train-100m"
LR = 1e-3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lake-dir", default="artifacts/lake_100m")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from .. import resolve_device
    from ..lake import DirLake
    from ..models import param_count
    from ..train.trainer import run_training

    device = resolve_device(None if args.device == "cuda" else args.device)
    cfg = CONFIG_100M
    print(f"model: {cfg.arch_id}, {param_count(cfg) / 1e6:.1f}M params, on {device}",
          flush=True)

    def on_step(step, loss):
        # nine digits: the f32 loss exactly, so a resumed run can be held to
        # another bit for bit
        print(f"step {step:4d}  loss {loss:.9g}", flush=True)

    res = run_training(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                       lake=DirLake(args.lake_dir), run_name=RUN_NAME,
                       ckpt_every=args.ckpt_every, lr=LR, device=device, on_step=on_step)
    print(f"\ndone: {res.steps_done} steps in {res.wall_time:.1f}s "
          f"({res.wall_time / max(len(res.losses), 1):.2f}s/step)")
    if res.resumed_from:
        print(f"(resumed from step {res.resumed_from} via named checkpoint)")
    if res.losses:
        print(f"loss: first {res.losses[0]:.3f} -> last {res.losses[-1]:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
