#!/usr/bin/env python3
"""Holds ``chip_smoke.py``'s raw read of a profile against ``prof.events()``.

    python3 scripts/profile_sums.py [--phases 9 12]

Runs ``chip_smoke.py``'s phase 9 (the executors' train and serve jobs,
each profiled whole, host and device) and phase 12 (the xLSTM's serve and
training windows) as the script runs them, with its ``device_events``
replaced by one that reads every finished profile both ways: off the
profiler's raw results, as the script does, and through ``prof.events()``.
For each profile it prints the number of device events, whether the two
lists of (name, start, end) are equal, and the seconds each read took;
it exits 1 if any pair differs.  GPU only.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", type=int, nargs="+", default=[9, 12], choices=[9, 12])
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_sums: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from torch.autograd import DeviceType

    import chip_smoke as C
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    print(C.card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    raw_read, reads = C.device_events, []

    def both(prof):
        t0 = time.perf_counter()
        raw = raw_read(prof)
        t1 = time.perf_counter()
        ref = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
               if e.device_type == DeviceType.CUDA]
        t2 = time.perf_counter()
        same = sorted(raw) == sorted(ref)
        reads.append(same)
        print(f"  [profile {len(reads)}] {len(raw)} device events raw, {len(ref)} from "
              f"prof.events(); equal {same}; raw read {t1 - t0:.2f} s, prof.events() "
              f"{t2 - t1:.2f} s", flush=True)
        return raw

    C.device_events = both
    phases = {9: ("phase 9: the executors on the card", C.executors),
              12: ("phase 12: serve and train xlstm-350m", C.serve_and_train_xlstm)}
    try:
        for p in args.phases:
            label, run = phases[p]
            with C.Phase(label):
                run(torch, np, dev)
    except C.SmokeFailure as exc:
        print(f"profile_sums: a phase failed: {exc}", file=sys.stderr)
        return 1
    print(f"profile_sums: {sum(reads)} of {len(reads)} profiles read equal both ways")
    return 0 if reads and all(reads) else 1


if __name__ == "__main__":
    sys.exit(main())
