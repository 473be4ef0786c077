"""Serve a small model with batched requests through the LIDC overlay, run
by the port on an H100.

The port's counterpart of the repo's ``examples/serve_batched.py``.  Shows
both layers: (a) the port's continuous-batching ``ServeEngine`` itself, and
(b) serving jobs placed by name across clusters with load sharing, through
an overlay built from the port's control plane (``build_fleet``), whose
serve executor runs the same engine::

    PYTHONPATH=src python -m repro_torch.examples.serve_batched            # the card
    PYTHONPATH=src python -m repro_torch.examples.serve_batched --smoke --device cpu
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict

import numpy as np

from ..core.strategy import LoadShareStrategy
from ..models import bundle_for
from ..runtime.executors import _resolve_arch
from ..runtime.fleet import build_fleet
from ..serve.engine import ServeEngine

__all__ = ["REQUESTS", "JOBS", "run"]

REQUESTS = 10          # engine requests of 6 prompt tokens, 8 new tokens each
JOBS = 6               # serve jobs of 4 requests x 8 new tokens


def run(device=None, *, arch: str = "lidc-demo", verbose: bool = True) -> Dict[str, Any]:
    """Serve ``REQUESTS`` requests through one engine, then ``JOBS`` serve
    jobs through a 3-cluster overlay; returns the engine's counts and each
    job's handle."""
    say = print if verbose else (lambda *a, **k: None)
    # (a) the engine itself: continuous batching, per-slot positions
    cfg = _resolve_arch(arch)          # as the fleet's serve executor resolves it
    params = bundle_for(cfg).init(cfg, 0, device=device)
    engine = ServeEngine(cfg, params, max_batch=4, max_seq=64, device=device)
    rng = np.random.default_rng(0)
    for _ in range(REQUESTS):
        engine.submit(list(rng.integers(0, cfg.vocab, 6)), max_new=8)
    done = engine.run()
    say(f"[engine] served {len(done)} requests, {engine.tokens_out} tokens "
        f"in {engine.decode_steps} decode steps "
        f"(continuous batching: {engine.tokens_out / engine.decode_steps:.2f} tokens/step)")
    served = {"requests": len(done), "tokens_out": engine.tokens_out,
              "decode_steps": engine.decode_steps}
    del engine, params

    # (b) the same thing as named computations over the overlay
    system = build_fleet(n_clusters=3, chips=16, archs=[arch], strategy=LoadShareStrategy(),
                         device=device)
    handles = []
    for i in range(JOBS):
        h = system.client.run_job({"app": "serve", "arch": arch, "requests": 4,
                                   "new_tokens": 8, "batch": i})
        if h is None or h.state != "Completed":
            raise RuntimeError(f"serve job {i} did not complete: {h and h.state}")
        handles.append(h)
    clusters = sorted({h.result["cluster"] for h in handles})
    say(f"[overlay] {JOBS} serving jobs load-shared across clusters: {clusters}")
    return {"engine": served, "handles": handles, "clusters": clusters,
            "virtual_s": system.net.now}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true", help="serve lidc-demo-smoke")
    args = ap.parse_args()
    out = run(args.device, arch="lidc-demo-smoke" if args.smoke else "lidc-demo")
    ok = out["engine"]["requests"] == REQUESTS and len(out["clusters"]) >= 2
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
