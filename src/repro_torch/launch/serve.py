"""Serving entrypoint: continuous-batching engine demo on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --requests 8 --max-new 16

Weights are random, drawn from a seeded ``torch.Generator``.  Runs on CUDA
unless ``--device cpu`` is given; with no GPU and no ``--device`` it fails.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="lidc-demo")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from .. import resolve_device
    from ..configs.base import get_config, smoke_of
    from ..models import bundle_for
    from ..serve.engine import ServeEngine

    device = resolve_device(None if args.device == "cuda" else args.device)
    cfg = smoke_of(args.arch) if args.smoke else get_config(args.arch)
    params = bundle_for(cfg).init(cfg, args.seed, device=device)
    eng = ServeEngine(cfg, params, max_batch=args.max_batch,
                      max_seq=args.max_seq, device=device)
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for _ in range(args.requests):
        eng.submit(rng.integers(0, cfg.vocab, 8).tolist(), max_new=args.max_new)
    done = eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"arch={cfg.arch_id} device={device} requests={len(done)} "
          f"tokens={eng.tokens_out} decode_steps={eng.decode_steps} "
          f"wall={dt:.2f}s tok/s={eng.tokens_out / max(dt, 1e-9):.1f}")
    for r in done[:3]:
        print(f"  req {r.rid}: prompt {r.prompt[:4]}... -> {r.out[:8]}...")


if __name__ == "__main__":
    main()
