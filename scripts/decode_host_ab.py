#!/usr/bin/env python3
"""Host time per served decode step of ``ServeEngine`` (qwen3-1.7b, 8 slots,
``chip_smoke.py`` phase 3's profiled step) with another version of the
port against this one, in turns on one GPU.

    python3 scripts/decode_host_ab.py OTHER_ROOT

``OTHER_ROOT`` is another checkout of the repository (for example a parent
commit unpacked with ``git archive`` under ``.archive/``, which git
ignores).  Each version runs in a process of its own, in
the order other, this, this, other: it builds its own kernels, draws the
weights (seed 0), prefills 8 prompts of 512 tokens and times 50 decode steps
by the host clock, the device synchronised at both ends only, after 10
warm-up steps; then the same under ``torch.profiler`` for the device's busy
time.  Each process prints one JSON line; the last line is a JSON object of
the four readings with the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCH, SLOTS, PROMPT, WARM, STEPS = "qwen3-1.7b", 8, 512, 10, 50


def worker(root: Path) -> None:
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import bundle_for
    from repro_torch.serve.engine import ServeEngine
    _build.build()
    dev = torch.device("cuda", 0)
    cfg = get_config(ARCH)
    params = bundle_for(cfg).init(cfg, 0, device=dev)
    eng = ServeEngine(cfg, params, max_batch=SLOTS, max_seq=2048, device=dev)
    rng = np.random.default_rng(2)
    for _ in range(SLOTS):
        eng.submit(rng.integers(0, cfg.vocab, PROMPT).tolist(), max_new=WARM + 2 * STEPS + 4)
    eng._admit()
    for _ in range(WARM):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        eng.step()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / STEPS
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(STEPS):
            eng.step()
        torch.cuda.synchronize()
    busy_ms = sum(e.device_time_total for e in prof.key_averages()) / 1e3 / STEPS
    print(json.dumps({"root": str(root), "host_ms_per_step": host_ms,
                      "device_busy_ms_per_step": busy_ms}), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        worker(Path(sys.argv[2]))
        return 0
    if len(sys.argv) != 2:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    import torch
    if not torch.cuda.is_available():
        print("decode_host_ab: needs a CUDA device", file=sys.stderr)
        return 1
    card = smoke.card_line()
    print(card)
    other = Path(sys.argv[1]).resolve()
    runs = []
    for label, root in (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)):
        out = subprocess.run([sys.executable, __file__, "--worker", str(root)],
                             stdout=subprocess.PIPE, text=True, check=True)
        reading = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"  {label}: {reading['host_ms_per_step']:.3f} ms host, "
              f"{reading['device_busy_ms_per_step']:.3f} ms device busy per decode step",
              flush=True)
        runs.append({"version": label, **reading})
    print(json.dumps({"device": card, "arch": ARCH, "slots": SLOTS, "prompt": PROMPT,
                      "steps": STEPS, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
