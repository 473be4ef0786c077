"""Training entry point, direct mode: run the trainer here, checkpoints in
a directory-backed lake (``--lake-dir``) or, without one, in memory.

    PYTHONPATH=src python -m repro_torch.launch.train --arch lidc-demo --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch lidc-demo --smoke \
        --steps 20 --device cpu --lake-dir artifacts/lake

With ``--lake-dir`` an interrupted run resumes from its latest checkpoint
when the same command is run again, and the directory is the one the
reference's ``repro.launch.train --lake-dir`` writes and reads, so a run
started on either framework resumes on the other.

Weights are random, drawn from a seeded ``torch.Generator``.  Runs on CUDA
unless ``--device cpu`` is given; with no GPU and no ``--device`` it fails.
The reference's second mode, ``--via-lidc``, submits the job to an overlay
that this launcher builds.  The overlay is the reference's pure-Python
control plane, which the port does not copy: the mode exits 2 here.  An H100
cluster joins a reference overlay through ``repro_torch.runtime.fleet``
(``standard_endpoints``), whose train executor runs this trainer.
"""

from __future__ import annotations

import argparse
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="lidc-demo")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--remat", default="none", choices=["none", "dots", "full"])
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--lake-dir", default=None,
                    help="directory-backed data lake (persists checkpoints)")
    ap.add_argument("--run-name", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--via-lidc", action="store_true",
                    help="submit through the LIDC overlay (the reference's; exits 2)")
    args = ap.parse_args()

    if args.via_lidc:
        print("--via-lidc: the LIDC overlay is the reference's control plane "
              "(repro.core), which the PyTorch port does not copy; an H100 cluster "
              "joins a reference overlay through repro_torch.runtime.fleet."
              "standard_endpoints. Use the direct mode here", file=sys.stderr)
        return 2

    from .. import resolve_device
    from ..configs.base import get_config, smoke_of
    from ..lake import DirLake, MemoryLake
    from ..train.trainer import run_training

    device = resolve_device(None if args.device == "cuda" else args.device)
    cfg = smoke_of(args.arch) if args.smoke else get_config(args.arch)
    lake = DirLake(args.lake_dir) if args.lake_dir else MemoryLake()
    res = run_training(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                       lake=lake, run_name=args.run_name or f"cli-{cfg.arch_id}",
                       ckpt_every=args.ckpt_every, lr=args.lr,
                       remat=args.remat, microbatch=args.microbatch, device=device,
                       on_step=lambda s, l: print(f"step {s:5d} loss {l:.4f}"))
    print(f"done: {res.steps_done} steps on {device}, final loss {res.final_loss:.4f}, "
          f"{res.wall_time:.1f}s" + (f", resumed from {res.resumed_from}"
                                     if res.resumed_from else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
