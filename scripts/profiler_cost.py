#!/usr/bin/env python3
"""What ``torch.profiler`` costs around whole overlay jobs on the card.

    python3 scripts/profiler_cost.py

Runs ``chip_smoke.py`` phase 18's quickstart (lidc-demo, 15 steps) and its
qwen3-1.7b serve job (8 requests x 32 tokens) through the port's own
overlay, each unprofiled, then under the profiler recording the device
only and recording the host and the device, and prints for each the time
to start the profiler, run the job, stop it, and turn its events into
``prof.events()``, with the number of events.  GPU only.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profiler_cost: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as C
    from repro_torch.configs.base import get_config
    from repro_torch.core import LidcSystem
    from repro_torch.examples import quickstart
    from repro_torch.kernels import _build
    from repro_torch.models import param_count
    from repro_torch.runtime import executors as ex
    from repro_torch.runtime.fleet import standard_endpoints

    dev = torch.device("cuda", 0)
    print(C.card_line())
    _build.build()
    arch, requests, new_tokens = C.OVERLAY_SERVE

    def serve_job():
        cfg = get_config(arch)
        system = LidcSystem()
        system.add_cluster("h100", chips=1, memory_model=ex.memory_model,
                           endpoints=standard_endpoints([arch], device=dev,
                                                        real_param_limit=2 * param_count(cfg)))
        system.client.run_job({"app": "serve", "arch": arch, "requests": requests,
                               "new_tokens": new_tokens})
        torch.cuda.synchronize()

    def quickstart_job():
        quickstart.run(dev, arch=C.OVERLAY_ARCH, verbose=False)
        torch.cuda.synchronize()

    for label, fn in (("quickstart", quickstart_job), ("serve", serve_job)):
        t0 = time.perf_counter()
        fn()
        print(f"{label}: unprofiled {time.perf_counter() - t0:.2f} s", flush=True)
        for acts in ([ProfilerActivity.CUDA], [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            t0 = time.perf_counter()
            with profile(activities=acts) as prof:
                t1 = time.perf_counter()
                fn()
                t2 = time.perf_counter()
            t3 = time.perf_counter()
            n, us = 0, 0.0
            for e in prof.events():
                n += 1
                if e.device_type == DeviceType.CUDA:
                    us += e.time_range.elapsed_us()
            t4 = time.perf_counter()
            print(f"{label} {[a.name for a in acts]}: start {t1 - t0:.2f} s, run "
                  f"{t2 - t1:.2f} s, stop {t3 - t2:.2f} s, events() {t4 - t3:.2f} s for "
                  f"{n} events ({us:.1f} device us)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
