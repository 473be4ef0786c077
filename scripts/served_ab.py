#!/usr/bin/env python3
"""A/B of one change inside a served decode step of ``chip_smoke.py``, on
one GPU: the host ms and the device busy ms per step of each setup, over
ROUNDS alternating windows of ``chip_smoke.profile_steps``.

    python3 scripts/served_ab.py silu

``silu`` serves zamba2-2.7b as phase 5 does (4 prompts of 700 tokens,
full width and depth) and steps it with the Mamba2 blocks' ``silu`` as the
port computes it (``layers.silu``: the reference's rounding, five
launches) and as ``F.silu`` (one launch).
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402  (stdlib only at import)

ROUNDS = 3   # profiler windows per setup, alternating


def compare(torch, step, setups) -> None:
    """Host and device busy ms per ``step`` under each of ``setups`` ({name:
    context manager factory}), ROUNDS windows each, alternating."""
    got = {name: [] for name in setups}
    for _ in range(ROUNDS):
        for name, setup in setups.items():
            with setup():
                print(f"[{name}]")
                got[name].append(smoke.profile_steps(torch, step, name))
    for name, runs in got.items():
        host = [round(r["host_ms"], 2) for r in runs]
        busy = [round(r["busy_ms"], 3) for r in runs]
        print(f"  {name}: host {host} ms/step (median {statistics.median(host):.2f}), device "
              f"busy {busy} ms/step (median {statistics.median(busy):.3f})")


def silu(torch, np, dev) -> None:
    import torch.nn.functional as F
    from repro_torch.configs.base import get_config
    from repro_torch.models import bundle_for
    from repro_torch.models import layers
    from repro_torch.train.step import make_prefill, make_serve_step
    arch, batch, prompt_len, max_seq, _ = smoke.HYBRID_RUN
    cfg = get_config(arch)
    params = bundle_for(cfg).init(cfg, 0, device=dev)
    prefill, serve_step = make_prefill(cfg), make_serve_step(cfg)
    toks = torch.tensor(np.random.default_rng(3).integers(0, cfg.vocab, (batch, prompt_len)),
                        dtype=torch.int32, device=dev)
    logits, cache = prefill(params, {"tokens": toks}, max_seq=max_seq)
    state = {"cache": cache, "nxt": logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)}
    del logits, cache

    def one_step():
        out, state["cache"] = serve_step(params, state["cache"], state["nxt"])
        state["nxt"] = out[:, -1].argmax(-1, keepdim=True).to(torch.int32)

    for _ in range(3):   # warm-up
        one_step()
    compare(torch, one_step, {
        "layers.silu (as shipped)": lambda: mock.patch.object(layers, "silu", layers.silu),
        "F.silu": lambda: mock.patch.object(layers, "silu", F.silu)})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("silu",))
    ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("served_ab: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi or "nvidia-smi: no output")
    silu(torch, np, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
