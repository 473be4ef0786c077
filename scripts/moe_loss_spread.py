#!/usr/bin/env python3
"""The spread of the bf16 paths' loss errors on qwen3-moe-30b-a3b at phase
10's width and depth (``chip_smoke.MOE_TRAIN_RUN``: 4 layers), on one GPU.

    python3 scripts/moe_loss_spread.py [--batches 12]

For each of ``--batches`` SyntheticLM batches of 1 x 1024 tokens (seeds 7,
8, ...; seed 7 is phase 10's gate batch), the loss (LM loss + 0.01 x aux)
through the kernel path, the plain path, the plain attention with the
router kernel and the attention kernel with the plain router, each
against the plain f32 path: the error of the mean loss per batch, and the
relative error of the vector of the tokens' losses (``chip_smoke.
token_losses``), which phase 10 gates.  Also the (token, rank) router ids
that differ between the kernel and plain paths.  Forward passes only.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import statistics
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402  (stdlib only at import)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batches", type=int, default=12)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("moe_loss_spread: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs.base import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops, ref
    from repro_torch.models import bundle_for
    from repro_torch.models import moe as M

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    arch, layers, _, seq = smoke.MOE_TRAIN_RUN[:4]
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = bundle_for(cfg).init(cfg, 0, device=dev)
    params32 = copy.deepcopy(params).float()
    paths = {"kernel": {},
             "plain": {"attention": ref.attention_ref, "moe_router": ref.moe_router_ref},
             "plain attention": {"attention": ref.attention_ref},
             "plain router": {"moe_router": ref.moe_router_ref}}
    routed = []

    def recording(fn):
        def route(x, router, k):
            out = fn(x, router, k)
            routed.append(out[1])
            return out
        return route

    def run(c, p, batch, patches):
        """(mean loss with the aux term, the tokens' losses, router ids)."""
        routed.clear()
        with contextlib.ExitStack() as stack, torch.no_grad():
            for name, fn in {**patches, "moe_router": recording(
                    patches.get("moe_router", ops.moe_router))}.items():
                stack.enter_context(mock.patch.object(ops, name, fn))
            loss = float(M.loss_fn(c, p, batch))
            ids = list(routed)
            return loss, smoke.token_losses(torch, c, p, batch), ids

    mean_err = {name: [] for name in paths}
    token_err = {name: [] for name in paths}
    for seed in range(7, 7 + args.batches):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in next(SyntheticLM(cfg, 1, seq, seed=seed)).items()}
        l32, t32, _ = run(cfg32, params32, batch, paths["plain"])
        line, ids = [], {}
        for name, patches in paths.items():
            loss, tok, ids[name] = run(cfg, params, batch, patches)
            mean_err[name].append(abs(loss - l32))
            token_err[name].append(float((tok - t32).norm() / t32.norm()))
            line.append(f"{name} {mean_err[name][-1]:.3e} / {token_err[name][-1]:.3e}")
        flips = sum(int((a != b).sum()) for a, b in zip(ids["kernel"], ids["plain"]))
        print(f"seed {seed}: f32 loss {l32:.6f}; |dloss| / tokens' relative err: "
              f"{'; '.join(line)}; ids differing kernel vs plain {flips} of "
              f"{sum(a.numel() for a in ids['kernel'])}")
    for name in paths:
        print(f"{name}: |dloss| mean {statistics.mean(mean_err[name]):.3e} median "
              f"{statistics.median(mean_err[name]):.3e} max {max(mean_err[name]):.3e}; "
              f"tokens' relative err mean {statistics.mean(token_err[name]):.3e} max "
              f"{max(token_err[name]):.3e}")
    for what, errs in (("|dloss|", mean_err), ("tokens' relative err", token_err)):
        ratios = [k / p for k, p in zip(errs["kernel"], errs["plain"])]
        print(f"kernel / plain, {what}, per batch: {[round(r, 3) for r in ratios]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
